"""PyTorch/CUDA kernels of the port and their plain versions."""
