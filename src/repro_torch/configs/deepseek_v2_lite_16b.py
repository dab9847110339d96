"""DeepSeek-V2-Lite (16B total / 2.4B active): MLA + fine-grained MoE.

[arXiv:2405.04434; hf]  27L d_model=2048 16H (kv=16) vocab=102400,
MLA kv_lora=512, MoE: 2 shared + 64 routed experts, top-6,
d_ff_expert=1408. Layer 0 uses a dense FFN (d_ff=10944), layers 1..26 MoE.
NOTE: the assignment sheet says both "64e top-6" and "160 routed"; the
released V2-Lite checkpoint has 64 routed experts — we follow that and the
"64e top-6" reading.
"""

from .base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                # dense FFN width (layer 0)
    vocab_size=102400,
    first_layer_dense=True,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408),
    source="arXiv:2405.04434; hf",
))
