"""Qwen1.5-4B: dense decoder with QKV bias (MHA: kv == heads == 20).

[hf:Qwen/Qwen1.5-0.5B; hf]  40L d_model=2560 20H (kv=20) d_ff=6912
vocab=151936. 20 heads do not divide the model axis (16): baseline
replicates attention over 'model' (see DESIGN.md §5).
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
))
