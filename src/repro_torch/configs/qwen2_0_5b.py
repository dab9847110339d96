"""Qwen2-0.5B: dense GQA decoder with QKV bias.

[arXiv:2407.10671; hf]  24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
14 heads do not divide the model axis (16): the baseline replicates
attention heads over 'model' (MLP/vocab still TP) — see DESIGN.md §5; the
§Perf hillclimb adds sequence-sharded attention.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671; hf",
))
