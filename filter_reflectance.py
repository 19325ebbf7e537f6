#!/usr/bin/env python
"""Drop-in entry point: bilateral/guided reflectance filtering.

Same flags and outputs as the reference script of the same name; the filters
run on the device (the bilateral as a Triton kernel on an NVIDIA GPU).  See
reflectance_filtering/cli/filter.py.
"""
from reflectance_filtering.cli.filter import main

if __name__ == "__main__":
    main()
