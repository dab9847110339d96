"""Training the MoE and MLA families: ``Model.train_loss`` and its
gradients for the reduced Qwen1.5-MoE-A2.7B and DeepSeek-V2-Lite against
the JAX package's ``jax.value_and_grad``, through the helpers and at the
tolerances of ``tests/test_torch_train.py``.

Routing. Where two router logits nearly tie, the two stacks' bf16 (and,
over 1,024 tokens, chunked-attention) roundings can send a token to
different experts, a discrete difference that is not the port's. As the
MoE serving tests do, the port's own routing in a ``train_loss`` forward
is held to the reference's jitted forward's by ``chip_smoke.routing_flips``
(every difference on a near tie, at most ``FLIP_SHARE`` of the positions
a layer); then both stacks take the reference's experts (each weighted by
its own router's probabilities) for the gradients. No seed is chosen to
avoid a flip: the tokens are seed 1's, as everywhere.
"""

import pytest
import torch

from test_torch_train import one_thread  # noqa: F401  (autouse)
from test_torch_train import F32_GRAD_TOL, GRAD_TOL, check_family


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("seq,dtype", [(32, torch.bfloat16), (1088, torch.bfloat16),
                                       (32, torch.float32)])
def test_moe_train_loss_and_grads_match_reference(arch, seq, dtype):
    check_family(arch, seq, dtype, GRAD_TOL if dtype == torch.bfloat16 else F32_GRAD_TOL,
                 dots=seq < 1024)
