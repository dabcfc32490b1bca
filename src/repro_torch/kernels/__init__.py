"""Hand-written CUDA kernels of the port, their wrappers and plain versions."""
