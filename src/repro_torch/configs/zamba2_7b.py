"""Zamba2-7B: Mamba2 backbone + shared attention block.

[arXiv:2411.15242; unverified]  81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64. Mamba2 blocks with a SHARED attention(+MLP)
block applied every 6th layer (shared weights — the Zamba signature).
Hybrid => long_500k runnable (attention KV cache is sharded over sequence;
mamba state is O(1)).
"""

from .base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=64, attn_every=6),
    source="arXiv:2411.15242; unverified",
))
