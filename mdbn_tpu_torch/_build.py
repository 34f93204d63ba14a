"""Build and load the package's CUDA kernels.

``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use (never at import, so the package imports on machines without
a GPU or ``nvcc``) into ``mdbn_tpu_torch/_build/<key>/``, where the key
hashes the sources and the flags; a later call with the same sources loads
the cached library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the build (0.0 when loaded from the cache)
    log: str  # the compiler's output (ptxas register/spill report)


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and under $CUDA_HOME or "
                       "/usr/local/cuda): the CUDA kernels of mdbn_tpu_torch are "
                       "built from source at first use on a machine with the "
                       "CUDA toolkit")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Compile (if not cached) and load the kernels' shared library. Raises
    with the compiler's output when nvcc is missing or the build fails."""
    out_dir = BUILD_DIR / _key()
    so = out_dir / "libmdbn_kernels.so"
    seconds, log = 0.0, ""
    if not so.exists():
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libmdbn_kernels.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in _sources() if s.suffix == ".cu"]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        (out_dir / "build.log").write_text(log)
    elif (out_dir / "build.log").exists():
        log = (out_dir / "build.log").read_text()
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    return Library(lib=lib, path=so, seconds=seconds, log=log)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cd_train_run.argtypes = (
        [p] * 19  # data, order, u_h0, u_h, u_v, u_swap, betas, W, b, c, vW, vb, vc, z, vz,
                  # chain, errs, scratch, trace
        + [i] * 10  # V, H, B, M, nb, E, k, start_epoch, switch_epoch, flags
        + [f] * 8  # lr, lr_z, momentum, initial_momentum, l2, grad_clip, sparsity_target/cost
        + [ctypes.c_uint64, i, i, p])  # seed, device, grid, stream
    lib.cd_train_run.restype = i
    lib.cd_train_scratch_floats.argtypes = [i, i, i, i, i]  # V, H, B, M, flags
    lib.cd_train_scratch_floats.restype = ctypes.c_longlong
    lib.cd_train_error_string.argtypes = [i]
    lib.cd_train_error_string.restype = ctypes.c_char_p
