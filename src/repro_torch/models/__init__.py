"""The model stack: layers, GQA attention (with K4), dense decoder layers,
the dense-family ``Model`` and the MoE routing and capacity semantics."""

from .model import (Model, count_active_params, count_params,
                    model_params_from_reference, param_shapes)

__all__ = ["Model", "count_params", "count_active_params", "param_shapes",
           "model_params_from_reference"]
