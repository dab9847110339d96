"""Whisper-small: encoder-decoder transformer; conv audio frontend STUBBED.

[arXiv:2212.04356; unverified]  12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865. Per the assignment the conv frontend is a stub:
``input_specs()`` provides 1500 precomputed frame embeddings for the
encoder. Decoder shapes use the assigned seq_len even beyond Whisper's
trained 448 positions ("backbone only"). 12 heads don't divide the model
axis: attention replicated over 'model' at baseline.
"""

from .base import ArchConfig, EncDecConfig, register

CONFIG = register(ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,               # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    encdec=EncDecConfig(n_enc_layers=12, n_enc_positions=1500),
    frontend="audio",
    source="arXiv:2212.04356; unverified",
))
