"""Hand-written CUDA kernels (``csrc/``), their build helper and wrappers.

Each wrapper module keeps the kernel's plain PyTorch version beside it:
CPU tensors run the plain version, CUDA tensors launch the kernel (or
raise). Importing this package builds nothing.
"""
