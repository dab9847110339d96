"""Training the recurrent families on the CPU: ``Model.train_loss`` and its
gradients for the reduced Zamba2-7B (Mamba2 layers, K5's plain version,
and the shared attention block) and RWKV6-3B (K6's plain version) against
the JAX package's ``jax.value_and_grad``, through the helpers and at the
tolerances of ``tests/test_torch_train.py`` (RWKV6 in bfloat16 at
``RWKV_GRAD_TOL``). At 1,088 tokens Zamba2's shared attention takes the
chunked impl (K4's plain version) and its scan runs 136 chunks of 8; that
run skips the "dots" repeat, which the 32-token runs check. RWKV6 has no
attention: over 1,088 tokens it takes no other path than over 32 (its
WKV runs in chunks of 8 at any length), so it runs at 32 only, to keep
the suite's time. On the card the scans' gradients are K5' and K6'
(``tests/test_torch_scan_bwd.py`` holds their plain versions to
``jax.vjp`` of the reference; ``tests/test_torch_cuda.py`` the kernels).
"""

import pytest
import torch

from test_torch_train import one_thread  # noqa: F401  (autouse)
from test_torch_train import F32_GRAD_TOL, GRAD_TOL, RWKV_GRAD_TOL, check_family


@pytest.mark.parametrize("arch,seq,dtype", [
    ("zamba2-7b", 32, torch.bfloat16), ("zamba2-7b", 1088, torch.bfloat16),
    ("zamba2-7b", 32, torch.float32), ("rwkv6-3b", 32, torch.bfloat16),
    ("rwkv6-3b", 32, torch.float32)])
def test_recurrent_train_loss_and_grads_match_reference(arch, seq, dtype):
    tol = F32_GRAD_TOL if dtype == torch.float32 else (
        RWKV_GRAD_TOL if arch == "rwkv6-3b" else GRAD_TOL)
    check_family(arch, seq, dtype, tol, dots=seq < 1024)
