"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each beside its
plain PyTorch version; ``build`` compiles and loads them at first use."""
