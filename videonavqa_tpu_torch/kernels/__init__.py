"""Hand-written CUDA kernels for Hopper, one module per ported Pallas kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter (``launches``, a plain int that the wrapper raises by one per
kernel launch). A wrapper runs the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises. Sources are in ``csrc/``.
"""
