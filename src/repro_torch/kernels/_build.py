"""Build the CUDA sources in ``csrc/`` at first use and bind them with ctypes.

Each source file becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the root
of the checkout. The library's file name carries a hash of its source, the
headers it may include (``csrc/*.cuh``) and the flags, so an edited source
or header is rebuilt and an unchanged one is reused.
Nothing here runs at import time: a ``Kernel`` compiles when it is first
called (or when ``build_all`` is asked to), so the CPU tests import every
module without a compiler.

No ``--use_fast_math``: the walker's ``scores`` body divides and takes a
square root before an argmax, and both must stay IEEE-rounded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the default."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


class Kernel:
    """One CUDA source, its built library, and its launch counts.

    ``launches`` counts launches per C entry point: ``launch`` adds one
    each time it launches the kernel, and nothing else touches it.
    """

    def __init__(self, source: str):
        self.source = CSRC / source
        self.launches: Counter = Counter()
        self._lib: ctypes.CDLL | None = None

    @property
    def library(self) -> Path:
        """Path of the built library, named by a hash of the source, the
        headers beside it (``csrc/*.cuh``) and the flags."""
        text = self.source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{digest}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this source unless its library exists."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        """Wait for ``proc`` and move its library into place; raise on failure."""
        if proc is None:
            return
        out, _ = proc.communicate()
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{out}")
        os.replace(tmp, self.library)

    def _load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, entry: str, *args) -> None:
        """Launch C entry point ``entry`` and count it; raise on a CUDA error.

        Every argument is a ``ctypes`` value (``c_void_p`` for pointers and
        the stream, ``c_int`` / ``c_longlong`` for sizes), so the declared
        argument types follow from the call. Each C entry point returns
        ``cudaGetLastError()`` right after its launch.
        """
        lib = self._load()
        f = getattr(lib, entry)
        f.argtypes = [type(a) for a in args]
        f.restype = ctypes.c_int
        err = f(*args)
        if err != 0:
            raise RuntimeError(
                f"{entry}: {lib.error_string(err).decode()} (CUDA error {err})")
        self.launches[entry] += 1


DAG_WALK = Kernel("dag_walk.cu")
CC_PROPAGATE = Kernel("cc_propagate.cu")
FLASH_ATTENTION = Kernel("flash_attention.cu")
FLASH_ATTENTION_BWD = Kernel("flash_attention_bwd.cu")
SSM_SCAN = Kernel("ssm_scan.cu")
SSM_SCAN_BWD = Kernel("ssm_scan_bwd.cu")
RWKV6_SCAN = Kernel("rwkv6_scan.cu")
RWKV6_SCAN_BWD = Kernel("rwkv6_scan_bwd.cu")
KERNELS = (DAG_WALK, CC_PROPAGATE, FLASH_ATTENTION, FLASH_ATTENTION_BWD, SSM_SCAN,
           SSM_SCAN_BWD, RWKV6_SCAN, RWKV6_SCAN_BWD)


def build_all() -> None:
    """Compile every kernel source at once, one ``nvcc`` per source."""
    procs = [(k, k.start_build()) for k in KERNELS]
    for k, p in procs:
        k.finish_build(p)


def seq_chunk(s: int, chunk: int) -> int:
    """The chunk a scan over ``s`` steps takes: ``min(chunk, s)``, which
    must divide ``s``."""
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"chunk {q} must divide the sequence length {s}")
    return q


def kernel_chunk(q: int, max_chunk: int) -> int:
    """The chunk a scan kernel built for chunks of at most ``max_chunk``
    runs in place of ``q``: ``q``, or else its largest divisor below
    ``max_chunk``. Chunk boundaries only choose how the scan's sums are
    grouped, so a chunk of 128 run as two of 64 computes the same
    function."""
    return max(d for d in range(1, min(q, max_chunk) + 1) if q % d == 0)


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of tensor ``t`` (``None`` gives a null pointer)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
