"""DaphneSched on PyTorch and CUDA: the port of the ``repro`` package.

The scheduler (partitioners, pipeline DAGs, frozen super-tables) is plain
numpy; the device path runs hand-written CUDA kernels for Hopper
(``csrc/``), built at first use. Entry points take a ``device`` argument
and default to ``"cuda"``.
"""
