"""PyTorch/CUDA port of the landmark-CF system (see README.md)."""
