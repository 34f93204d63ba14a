"""Build and load the package's CUDA kernels.

Each ``csrc/<kernel>.cu`` is compiled with ``nvcc`` for ``sm_90a`` once per
storage type (``-DMDBN_STORE_BF16=0|1``: float32 or bfloat16 parameters, see
``csrc/cd_common.cuh``) into a shared library of its own with a plain C
interface, loaded with ``ctypes``; the resident kernel's estimator modes are
libraries of their own from the same source (``VARIANTS``: without and with
a tempering ladder), and so is its data-parallel step in each of the three
(``cd_grads_resident*``), so its six variants compile in parallel. The build
happens at first use (never at import, so the package imports on machines
without a GPU or ``nvcc``) into
``mdbn_tpu_torch/_build/<key>/``, where the key hashes the sources and the
flags; the first use of any kernel builds every library that is missing, one
``nvcc`` process each, all started together; a later call with the same
sources loads the cached libraries.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# kernel -> the storage types it is built at
KERNELS = {"cd_train": ("float32", "bfloat16"), "cd_train_wide": ("float32", "bfloat16"),
           "cd_train_resident": ("float32", "bfloat16"),
           "cd_train_resident_modes": ("float32", "bfloat16"),
           "cd_train_resident_ladder": ("float32", "bfloat16"),
           "cd_train_wide_modes": ("float32", "bfloat16"),
           "cd_grads": ("float32", "bfloat16"), "cd_grads_wide": ("float32", "bfloat16"),
           "cd_grads_resident": ("float32", "bfloat16"),
           "cd_grads_resident_modes": ("float32", "bfloat16"),
           "cd_grads_resident_ladder": ("float32", "bfloat16")}

# a library built from another kernel's source, with its flags
VARIANTS = {"cd_train_resident_modes": ("cd_train_resident", ["-DMDBN_RESIDENT_MODES=1"]),
            "cd_train_resident_ladder": ("cd_train_resident", ["-DMDBN_RESIDENT_MODES=2"]),
            "cd_grads_resident": ("cd_train_resident", ["-DMDBN_RESIDENT_STEP=1"]),
            "cd_grads_resident_modes": ("cd_train_resident", ["-DMDBN_RESIDENT_MODES=1",
                                                              "-DMDBN_RESIDENT_STEP=1"]),
            "cd_grads_resident_ladder": ("cd_train_resident", ["-DMDBN_RESIDENT_MODES=2",
                                                               "-DMDBN_RESIDENT_STEP=1"])}


@dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of this library's nvcc (0.0 when loaded from the cache)
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


def _so(out_dir: Path, kernel: str, storage: str) -> Path:
    return out_dir / f"lib{kernel}_{storage}.so"


def _compile(nvcc: str, out_dir: Path, kernel: str, storage: str) -> Tuple[float, str]:
    so = _so(out_dir, kernel, storage)
    tmp = out_dir / f"{so.stem}.{os.getpid()}.tmp.so"
    src, flags = VARIANTS.get(kernel, (kernel, []))
    cmd = [nvcc, *NVCC_FLAGS, f"-DMDBN_STORE_BF16={int(storage == 'bfloat16')}", *flags,
           "-o", str(tmp), str(CSRC / f"{src}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return seconds, log


@functools.lru_cache(maxsize=None)
def build_all() -> Dict[Tuple[str, str], Library]:
    """Compile (where not cached) and load every kernel library:
    {(kernel, storage): Library}. Raises with the compiler's output when nvcc
    is missing or a build fails."""
    out_dir = BUILD_DIR / _key()
    units = [(k, s) for k, storages in KERNELS.items() for s in storages]
    missing = [u for u in units if not _so(out_dir, *u).exists()]
    built: Dict[Tuple[str, str], Tuple[float, str]] = {}
    if missing:
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(len(missing)) as pool:
            jobs = {u: pool.submit(_compile, nvcc, out_dir, *u) for u in missing}
            built = {u: job.result() for u, job in jobs.items()}
    libs = {}
    for u in units:
        so = _so(out_dir, *u)
        seconds, log = built.get(u, (0.0, ""))
        if u not in built and so.with_suffix(".log").exists():
            log = so.with_suffix(".log").read_text()
        lib = ctypes.CDLL(str(so))
        _DECLARE[u[0]](lib)
        libs[u] = Library(lib=lib, path=so, seconds=seconds, log=log)
    return libs


def load_library(kernel: str = "cd_train", storage: str = "float32") -> Library:
    """The library of ``kernel`` (a key of ``KERNELS``) at ``storage``
    ("float32", "bfloat16"), built at first use."""
    return build_all()[(kernel, storage)]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [ctypes.c_uint64, _I, _I, _P]  # seed, device, grid, stream


def _declare_error_string(lib: ctypes.CDLL, name: str) -> None:
    fn = getattr(lib, name)
    fn.argtypes = [_I]
    fn.restype = ctypes.c_char_p


def _declare_train_run(lib: ctypes.CDLL, name: str) -> None:
    """``<name>_run``, ``<name>_scratch_floats`` and ``<name>_error_string``
    of cd_train.cu, cd_train_wide_modes.cu and cd_train_resident.cu, which
    take the same arguments."""
    run = getattr(lib, f"{name}_run")
    run.argtypes = (
        [_P] * 19  # data, order, u_h0, u_h, u_v, u_swap, betas, W, b, c, vW, vb, vc, z, vz,
                   # chain, errs, scratch, trace
        + [_I] * 10  # V, H, B, M, nb, E, k, start_epoch, switch_epoch, flags
        + [_F] * 8  # lr, lr_z, momentum, initial_momentum, l2, grad_clip, sparsity_target/cost
        + _TAIL)
    run.restype = _I
    scratch = getattr(lib, f"{name}_scratch_floats")
    scratch.argtypes = [_I] * 5  # V, H, B, M, flags
    scratch.restype = ctypes.c_longlong
    _declare_error_string(lib, f"{name}_error_string")


def _declare_cd_train(lib: ctypes.CDLL) -> None:
    _declare_train_run(lib, "cd_train")


def _declare_cd_train_wide_modes(lib: ctypes.CDLL) -> None:
    _declare_train_run(lib, "cd_train_wide_modes")


def _declare_cd_train_wide(lib: ctypes.CDLL) -> None:
    lib.cd_train_wide_run.argtypes = (
        [_P] * 14  # data, order, u_h0, u_h, W, b, c, vW, vb, vc, chain, errs, scratch, trace
        + [_I] * 9  # V, H, B, nb, E, k, start_epoch, switch_epoch, flags
        + [_F] * 7  # lr, momentum, initial_momentum, l2, grad_clip, sparsity_target/cost
        + _TAIL)
    lib.cd_train_wide_run.restype = _I
    lib.cd_train_wide_scratch_floats.argtypes = [_I] * 3  # V, H, B
    lib.cd_train_wide_scratch_floats.restype = ctypes.c_longlong
    lib.cd_train_wide_plan.argtypes = [_I] * 3 + [_F] * 2 + [_I, _P]  # H, B, flags,
    # momentum, initial_momentum, limit, out[8]
    lib.cd_train_wide_plan.restype = None
    _declare_error_string(lib, "cd_train_wide_error_string")


def _declare_cd_train_resident(lib: ctypes.CDLL) -> None:
    _declare_train_run(lib, "cd_train_resident")  # the tail's grid: clusters
    lib.cd_train_resident_tiling.argtypes = [_I, _I, _P]  # V, H, out[4]
    lib.cd_train_resident_tiling.restype = None
    lib.cd_train_resident_smem_bytes.argtypes = [_I] * 6  # V, H, B, M, flags, strips a block
    lib.cd_train_resident_smem_bytes.restype = _I
    lib.cd_train_resident_limits.argtypes = [_I, _I, _I, _P]  # V, H, device, out[2]
    lib.cd_train_resident_limits.restype = _I


def _declare_cd_grads_resident(lib: ctypes.CDLL) -> None:
    _declare_cd_train_resident(lib)
    lib.cd_grads_resident_step.argtypes = (
        [_P] * 17  # data, tab, mask, u_h0, u_h, u_v, u_swap, betas, W, b, c, z, chain_in,
                   # out, chain_out, scratch, trace
        + [_I] * 7  # V, H, B, M, k, flags, bit
        + [_F] * 3  # inv_norm, sparsity_target, sparsity_cost
        + _TAIL)  # the tail's grid: clusters
    lib.cd_grads_resident_step.restype = _I


def _declare_cd_grads(lib: ctypes.CDLL) -> None:
    lib.cd_grads_step.argtypes = (
        [_P] * 16  # v0, tab, mask, u_h0, u_h, u_v, u_swap, betas, W, b, c, z, chain_in, out,
                   # chain_out, scratch
        + [_I] * 7  # V, H, B, M, k, flags, bit
        + [_F] * 3  # inv_norm, sparsity_target, sparsity_cost
        + _TAIL)
    lib.cd_grads_step.restype = _I
    lib.cd_update_step.argtypes = (
        [_P] * 12  # sums, W, b, c, z, vW, vb, vc, vz, err, part, mom
        + [_I] * 3  # V, H, flags
        + [_F] * 8  # scale, lr, lr_z, momentum, l2, grad_clip, sparsity_target/cost
        + [_I, _P])  # device, stream
    lib.cd_update_step.restype = _I
    lib.cd_grads_scratch_floats.argtypes = [_I] * 5  # V, H, B, M, flags
    lib.cd_grads_scratch_floats.restype = ctypes.c_longlong
    lib.cd_enhance_scratch_floats.argtypes = [_I] * 2  # V, H
    lib.cd_enhance_scratch_floats.restype = ctypes.c_longlong
    lib.cd_grads_prepare.argtypes = [_I]  # device
    lib.cd_grads_prepare.restype = _I
    _declare_error_string(lib, "cd_grads_error_string")


def _declare_cd_grads_wide(lib: ctypes.CDLL) -> None:
    lib.cd_wide_step.argtypes = (
        [_P] * 11  # v0, tab, u_h0, u_h, W, b, c, chain_in, chain_out, slot, scratch
        + [_I] * 6  # V, H, B, k, flags, nvalid
        + [_F]  # inv_norm
        + _TAIL)
    lib.cd_wide_step.restype = _I
    lib.cd_wide_update.argtypes = (
        [_P, _P, ctypes.c_longlong]  # v0, tab, v0_stride
        + [_P] * 10  # gathered, W, b, c, vW, vb, vc, err, mom, trace
        + [_I] * 7  # V, H, R, lb, ndev, flags, vel
        + [_F] * 7  # scale, lr, momentum, l2, grad_clip, sparsity_target/cost
        + [_I, _I, _P])  # device, grid, stream
    lib.cd_wide_update.restype = _I
    lib.cd_wide_prepare.argtypes = [_I] * 7  # V, H, B, R, flags, vel, device
    lib.cd_wide_prepare.restype = _I
    lib.cd_wide_update_plan.argtypes = [_I] * 8 + [_P]  # V, H, R, flags, vel, aligned, limit,
    # per_sm, out[7]
    lib.cd_wide_update_plan.restype = None
    for name in ("cd_wide_slot_bytes", "cd_wide_scratch_floats"):
        getattr(lib, name).argtypes = [_I] * 3  # V, H, B
        getattr(lib, name).restype = ctypes.c_longlong
    _declare_error_string(lib, "cd_grads_wide_error_string")


_DECLARE = {"cd_train": _declare_cd_train, "cd_train_wide": _declare_cd_train_wide,
            "cd_train_resident": _declare_cd_train_resident,
            "cd_train_resident_modes": _declare_cd_train_resident,
            "cd_train_resident_ladder": _declare_cd_train_resident,
            "cd_train_wide_modes": _declare_cd_train_wide_modes,
            "cd_grads": _declare_cd_grads, "cd_grads_wide": _declare_cd_grads_wide,
            "cd_grads_resident": _declare_cd_grads_resident,
            "cd_grads_resident_modes": _declare_cd_grads_resident,
            "cd_grads_resident_ladder": _declare_cd_grads_resident}
