"""Hand-written CUDA kernels and their wrappers.

Each wrapper module holds the kernel's launch, its plain PyTorch version
and a launch count. A wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""
