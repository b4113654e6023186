"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes wrappers,
the nvcc build, and the plain PyTorch versions they are held against."""
