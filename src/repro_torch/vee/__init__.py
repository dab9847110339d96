"""The paper's IDA pipelines and the MoE expert dispatch on the device path."""

from .ml_apps import moe_device_lowering, moe_dispatch_lowering, skewed_tokens

__all__ = ["moe_dispatch_lowering", "moe_device_lowering", "skewed_tokens"]
