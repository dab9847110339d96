"""Device kernels: the super-table walker, the CC propagation step, flash
attention and the two recurrent scans (Mamba2's SSD, RWKV6's WKV).

Each kernel module holds a plain PyTorch version and a wrapper that, for
CUDA tensors, launches the hand-written CUDA kernel from ``csrc/``.
"""
