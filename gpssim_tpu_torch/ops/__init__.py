"""Per-sample synthesis kernels (NumPy parity path, PyTorch and CUDA)."""
