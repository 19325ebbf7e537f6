#!/usr/bin/env python
"""Drop-in entry point: decompose an image with the trained reflectance CNN.

Same flags and outputs as the reference script of the same name; the compute
runs as one device program (a fused Triton kernel on an NVIDIA GPU).  See
reflectance_filtering/cli/decompose.py.
"""
from reflectance_filtering.cli.decompose import main

if __name__ == "__main__":
    main()
