"""Hand-written Hopper kernels (CUDA C++ for sm_90a under ``csrc/``), each
beside its plain PyTorch version; ``ops`` dispatches between them."""
