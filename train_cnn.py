#!/usr/bin/env python
"""Entry point: train / predict / decompose experiments.

Flag-compatible with the reference's training/train_with_barrista.py; the
training step runs as a single XLA program per batch.  See
reflectance_filtering/cli/train.py.
"""
from reflectance_filtering.cli.train import main

if __name__ == "__main__":
    main()
