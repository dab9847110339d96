"""Train and serve steps and the fault-tolerant loop (the port's copy of the
``steps`` and ``fault`` parts of ``repro/runtime``; the mesh rules and
sharding annotations wait for ROADMAP A17)."""

from . import fault
from .steps import (TrainState, build_decode_step, build_prefill_step,
                    build_train_step, init_train_state, loss_and_grads)

__all__ = ["TrainState", "build_train_step", "build_prefill_step",
           "build_decode_step", "init_train_state", "loss_and_grads", "fault"]
