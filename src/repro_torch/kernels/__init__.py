"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) with their plain
PyTorch versions (``ref.py``), which the wrappers run for CPU tensors."""
