"""What the examples share: the ``--torch-device`` flag and its device, the
launch counts of the kernels a run reached, and the host's sync."""

from __future__ import annotations

import argparse
import contextlib

import torch

__all__ = ["add_device_flag", "checks_line", "hold_linreg", "kernel_launches",
           "resolve_device", "sync"]


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    """``--torch-device``: where the example's tensors live (default the card)."""
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device of the example's tensors and kernels: cuda "
                         "(default; raises without a card) or cpu (the kernels' "
                         "plain versions)")


def resolve_device(name) -> torch.device:
    """``name`` as a device; ``cuda`` without a card raises rather than run
    on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--torch-device cuda: no CUDA device is available; pass "
                           "--torch-device cpu to run on the CPU")
    return device


def sync(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def kernel_launches():
    """Yields a dict that holds, on exit, each kernel entry point launched
    inside the block and its launches (the wrappers' counts, not reset)."""
    from ..kernels import _build

    def counts() -> dict:
        return {e: n for k in _build.KERNELS for e, n in k.launches.items()}

    before, out = counts(), {}
    try:
        yield out
    finally:
        out.update({e: n - before.get(e, 0) for e, n in counts().items()
                    if n > before.get(e, 0)})


def hold_linreg(low, got: dict, want: dict, exact: bool, what: str) -> dict:
    """Hold the two sums of a linreg lowering's run (``got``: stage values)
    to another run's (``want``). ``exact`` (both ran the plain versions'
    arithmetic: the CPU): bitwise. Else each within twice its limit
    (``kernels/limits.py``: eps32 * sqrt(tiles) * sum|terms|, two summers):
    ``moments`` against ``want``'s, ``syrk_gemv`` against the host op run on
    ``got``'s own moments, since a sum standardized by other moments sums
    other terms (EPS32's note). Returns each stage's ``"bitwise"`` or worst
    share of its limit; raises AssertionError past it."""
    from ..kernels.limits import hold

    host = {k: torch.as_tensor(v).cpu() for k, v in got.items()}
    other = {k: torch.as_tensor(v).cpu() for k, v in want.items()}
    if exact:
        return {k: hold(host[k], other[k], None, 0, f"{what} {k}", exact=True)
                for k in ("moments", "syrk_gemv")}
    X, y = low.values["X"].cpu().double(), low.values["y"].cpu().double()
    n, units = X.shape[0], X.shape[0] // low.tile
    M = host["moments"].double()
    mean = M[0] / n
    std = torch.sqrt(torch.clamp(M[1] / n - mean * mean, min=0.0))
    std = torch.where(std == 0, torch.ones_like(std), std)
    z = torch.cat([(X - mean) / std, torch.ones_like(y), y], dim=1).abs()
    syrk_here = low.dag.stages["syrk_gemv"].op({"moments": host["moments"]}, 0, units)
    return {"moments": hold(host["moments"], other["moments"],
                            torch.stack([X.abs().sum(0), (X * X).sum(0)]), units,
                            f"{what} moments", exact=False),
            "syrk_gemv": hold(host["syrk_gemv"], syrk_here, (z[:, :-1].T @ z), units,
                              f"{what} syrk_gemv", exact=False)}


def checks_line(checks: dict) -> str:
    """``hold_linreg``'s result as the examples print it."""
    if all(v == "bitwise" for v in checks.values()):
        return "bit-equal: True"
    return ("within the sums' limits: worst share "
            + ", ".join(f"{k} {v:.3f}" for k, v in checks.items()))
