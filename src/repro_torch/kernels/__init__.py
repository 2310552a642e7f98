"""FLARE kernels for Hopper (CUDA C++ in ``csrc/``) and their plain versions."""
