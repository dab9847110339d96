"""Device kernels: the super-table walker and the CC propagation step.

Each kernel module holds a plain PyTorch version and a wrapper that, for
CUDA tensors, launches the hand-written CUDA kernel from ``csrc/``.
"""
