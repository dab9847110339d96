"""Architecture + shape configuration schema (the port's copy).

Every assigned architecture is a frozen ``ArchConfig``; the four assigned
input shapes are ``ShapeConfig``s. ``reduced()`` returns the same family at
smoke-test scale (small layers/width/experts, tiny vocab) for CPU tests.
The registry holds the same ten architectures as ``repro/configs``, field
for field; the MoE dispatch lowering (``vee/ml_apps.py``) runs at either
the full or the reduced widths, and the model stack (``models/``) builds
the dense family from them.

Vocab sizes are padded to a multiple of 256 (``vocab_pad``) so the embedding
shards evenly over the model axis (Megatron-style padding); routed expert
counts are padded to a multiple of the model-axis size similarly (router
masks padding experts).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

__all__ = [
    "ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig",
    "EncDecConfig", "ShapeConfig", "SHAPES", "pad_to", "register", "get_config",
    "list_configs", "REGISTRY",
]


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int            # routed experts (pre-padding)
    n_shared: int            # shared (always-on) experts
    top_k: int
    d_ff_expert: int         # per-expert FFN width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    n_routed_padded: int = 0  # filled by ArchConfig.finalize

    def padded(self, mult: int) -> "MoEConfig":
        return dataclasses.replace(self, n_routed_padded=pad_to(self.n_routed, mult))


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = full-rank Q (V2-Lite has no Q LoRA)
    rope_head_dim: int = 64       # decoupled RoPE dims per head
    nope_head_dim: int = 128      # non-RoPE dims per head
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config."""
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 64
    conv_width: int = 4
    attn_every: int = 0     # hybrid: apply shared attention after every k-th block


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64    # low-rank width of the data-dependent decay MLP
    chunk: int = 64


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    n_enc_positions: int    # e.g. whisper: 1500 audio frames


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""             # citation tag

    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    encdec: EncDecConfig | None = None
    frontend: str | None = None  # "vision" | "audio" (stub embeddings)
    n_frontend_tokens: int = 0   # prefix embeds provided by the stub
    first_layer_dense: bool = False  # deepseek-v2: layer 0 uses dense FFN

    # runtime knobs
    vocab_pad_multiple: int = 256
    use_pallas: bool = False     # the reference's kernel switch, kept for parity
    remat: bool = True
    remat_policy: str = "full"   # full | dots (save dot outputs in bwd)
    attn_impl: str = "chunked"   # chunked | banded | full (see models/attention)
    attn_chunk_q: int = 512      # chunked-flash block sizes
    attn_chunk_kv: int = 1024

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def is_attention_free(self) -> bool:
        return self.rwkv is not None

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> long_500k runnable."""
        return self.rwkv is not None or self.ssm is not None

    def moe_padded(self, model_axis: int) -> MoEConfig | None:
        return self.moe.padded(model_axis) if self.moe else None

    def param_count(self) -> int:
        """Parameter count (embeddings + blocks), for 6ND.

        Counted on the ``meta`` device by ``models/model.py:count_params``.
        """
        from ..models.model import count_params  # lazy, avoids a cycle
        return count_params(self)

    def reduced(self) -> "ArchConfig":
        """Smoke-test scale config of the same family."""
        kw: dict = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(1, self.n_heads))),
            d_ff=128,
            vocab_size=503,     # deliberately non-multiple of 256 (tests padding)
            d_head=16,
            vocab_pad_multiple=64,
            attn_chunk_q=16,
            attn_chunk_kv=32,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_routed=6, n_shared=min(2, self.moe.n_shared),
                top_k=2, d_ff_expert=32, n_routed_padded=0)
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora_rank=32, rope_head_dim=8,
                                  nope_head_dim=16, v_head_dim=16)
            kw["d_head"] = 0
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk=8)
        if self.rwkv:
            kw["rwkv"] = dataclasses.replace(self.rwkv, head_dim=16, decay_lora=8, chunk=8)
            kw["n_heads"] = 4
        if self.encdec:
            kw["encdec"] = EncDecConfig(n_enc_layers=2, n_enc_positions=30)
        if self.frontend:
            kw["n_frontend_tokens"] = 8
        return dataclasses.replace(self, **kw)


REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}") from None


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(REGISTRY)


def _ensure_loaded() -> None:
    if REGISTRY:
        return
    import importlib
    for mod in (
        "internvl2_26b", "zamba2_7b", "granite_8b", "qwen2_0_5b", "yi_9b",
        "qwen1_5_4b", "whisper_small", "deepseek_v2_lite_16b",
        "qwen2_moe_a2_7b", "rwkv6_3b",
    ):
        importlib.import_module(f"{__package__}.{mod}")
