"""PyTorch / CUDA port of the A-FADMM system (counterpart of ``repro``).

Importing the package loads no CUDA and builds nothing: the kernels in
``repro_torch.kernels`` are compiled with nvcc at their first launch.
"""
