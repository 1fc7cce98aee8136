"""Build and load the CUDA kernels in ``csrc/``; launch counters."""
