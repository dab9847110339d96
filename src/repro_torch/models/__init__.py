"""The model stack: layers, GQA, cross attention and MLA (with K4), the MoE
block, the decoder layers and ``Model`` for every family of ``configs``:
dense, MoE, MLA, RWKV6, Zamba2, Whisper's encoder-decoder and InternVL2's
vision frontend."""

from .model import (Model, count_active_params, count_params,
                    model_params_from_reference, param_shapes)

__all__ = ["Model", "count_params", "count_active_params", "param_shapes",
           "model_params_from_reference"]
