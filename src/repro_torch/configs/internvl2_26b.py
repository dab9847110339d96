"""InternVL2-26B language backbone (InternLM2-20B) + ViT stub frontend.

[arXiv:2404.16821; hf]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. The InternViT-6B vision tower is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings (projected to
d_model) that are prepended to the token sequence.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    frontend="vision",
    n_frontend_tokens=256,   # one image tile = 256 patch embeddings
    source="arXiv:2404.16821; hf",
))
