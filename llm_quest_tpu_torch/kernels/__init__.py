"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), their
build helper and their plain PyTorch versions."""
