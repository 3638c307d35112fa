"""Attention kernels for Hopper (CUDA C++ under csrc/), their plain
PyTorch versions and the dispatch layer."""
