"""Time the scans' backward kernels (K5', K6') of one checkout on the card.

Run from the root of this repository, naming the checkout whose
``src/repro_torch`` and ``chip_smoke.py`` to load (the working tree by
default, or an unpacked older commit, to compare two versions in one
call, in turns: old, new, new, old)::

    python tools/scan_bwd_times.py [--root DIR] [--reps N]

At the training shapes of ``chip_smoke.py``'s train phases, with synthetic
inputs made on the card from a seed: K5' at Zamba2-7B's (x, B and C bf16
strided views of one conv output of 4 x 2,048 steps, 112 heads of 64, N =
64, chunk 64) and K6' at RWKV6-3B's (r, k, v bf16 transposed head views of
one projection, 4 x 40 heads x 2,048 x 64, the smoke's fast-decay logw,
chunk 64), y's gradient randn. Prints one JSON line a kernel: the call's
milliseconds by CUDA events (median of ``--reps``), the device ms of a call
and of each of its kernels by ``torch.profiler`` (the smoke's
``kernel_device_ms``), and the card's name and power limit. Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path


def load(root: Path):
    """``chip_smoke.py`` of ``root`` as a module, with ``root/src`` first on
    the import path."""
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    smoke = load(args.root.resolve())
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rwkv6_scan, ssm_scan

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    card = smoke.card_line()

    # K5' at Zamba2-7B's training shape
    bt, s, h, n = 4, 2048, 112, 64
    conv = torch.randn((bt, s, h * 64 + 2 * n), generator=gen, device=dev).bfloat16()
    x = conv[..., :h * 64].reshape(bt, s, h, 64)
    B, C = conv[..., h * 64:h * 64 + n], conv[..., h * 64 + n:]
    dt = F.softplus(torch.randn((bt, s, h), generator=gen, device=dev) - 3.0)
    A = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.5)
    _, _, cum, states = ssm_scan._forward(x, dt, A, B, C, 64)
    dy = torch.randn((bt, s, h, 64), generator=gen, device=dev)
    call = lambda: ssm_scan.ssm_scan_bwd(x, dt, A, B, C, cum, states, dy, None)  # noqa: E731
    names = ("ssm_bwd_states", "ssm_bwd_chunks", "ssm_bwd_fold")
    report(smoke, "ssm_scan_bwd[Zamba2-7B train shape]", call, names, args.reps, card)
    del conv, x, B, C, dt, cum, states, dy
    torch.cuda.empty_cache()

    # K6' at RWKV6-3B's training shape
    b, h, s = 4, 40, 2048
    proj = torch.randn((b, s, 3 * h * 64), generator=gen, device=dev).bfloat16()
    r, k, v = (proj[..., i * h * 64:(i + 1) * h * 64].reshape(b, s, h, 64).transpose(1, 2)
               for i in range(3))
    z = torch.randn((b, h, s, 64), generator=gen, device=dev)
    logw = torch.clamp(-torch.exp(4.0 * z), min=-30.0)
    u = torch.randn((h, 64), generator=gen, device=dev) * 0.1
    _, final, states = rwkv6_scan._forward(r, k, v, logw, u, 64)
    dy = torch.randn((b, h, s, 64), generator=gen, device=dev)
    call = lambda: rwkv6_scan.rwkv6_scan_bwd(r, k, v, logw, u, states, final, dy, None)  # noqa: E731
    names = ("rwkv6_bwd_states", "rwkv6_bwd_chunks", "rwkv6_bwd_fold")
    report(smoke, "rwkv6_scan_bwd[RWKV6-3B train shape]", call, names, args.reps, card)


def report(smoke, name: str, call, names: tuple, reps: int, card: str) -> None:
    ms = smoke.timed(call, reps, warmup=2)
    device = smoke.kernel_device_ms(call, names, reps=3)
    by_kernel = {k: smoke.kernel_device_ms(call, (k,), reps=3)["device_ms"] for k in names}
    print(json.dumps(dict(name=name, ms=ms, **device, device_ms_by_kernel=by_kernel,
                          card=card)), flush=True)


if __name__ == "__main__":
    main()
