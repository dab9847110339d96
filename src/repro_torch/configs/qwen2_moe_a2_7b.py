"""Qwen1.5-MoE-A2.7B: 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (kv=16)
d_ff_expert=1408 vocab=151936. 60 routed experts don't divide the model
axis (16): padded to 64 with router-masked dummies (DESIGN.md §5).
"""

from .base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,                  # shared-expert combined width
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(n_routed=60, n_shared=4, top_k=4, d_ff_expert=1408),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
))
