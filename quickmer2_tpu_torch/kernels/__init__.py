"""Hand-written CUDA kernels (csrc/) with their wrappers and plain
PyTorch versions. Nothing here builds or imports CUDA code at import
time: the kernels compile with nvcc on first launch (kernels.build)."""
