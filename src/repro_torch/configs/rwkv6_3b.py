"""RWKV6-3B ("Finch"): attention-free, data-dependent decay.

[arXiv:2404.05892; hf]  32L d_model=2560 d_ff=8960 vocab=65536, head_dim=64
(40 wkv heads — padded to 48 for the model axis, DESIGN.md §5). SSM-class
=> long_500k runnable with O(1) decode state.
"""

from .base import ArchConfig, RWKVConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                 # 2560 / 64 wkv heads
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, chunk=64),
    source="arXiv:2404.05892; hf",
))
