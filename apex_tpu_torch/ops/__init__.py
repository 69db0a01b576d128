"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Counterpart of ``apex_tpu.ops.pallas``. Each kernel module holds the
wrapper (launches the kernel for CUDA tensors, runs the plain version for
CPU tensors) and the plain version; ``_build`` compiles ``csrc/*.cu``.
"""
