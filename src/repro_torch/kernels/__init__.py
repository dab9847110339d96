"""Device kernels: the super-table walker, the CC propagation step and
flash attention.

Each kernel module holds a plain PyTorch version and a wrapper that, for
CUDA tensors, launches the hand-written CUDA kernel from ``csrc/``.
"""
