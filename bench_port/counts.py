"""Frozen yardsticks: the card's peaks, and the operations and bytes of the CD
kernels' work, worked out from a configuration's shapes.

Copies of the measured program's smoke script (``chip_smoke.py``:
``PEAK_*``, ``update_flops``, ``bound``, ``wide_step_bound``,
``wide_update_bound``) that take the benchmark's configuration dicts, so a
later change to the program cannot move them. Each bound is the least time the
card needs: the larger of the operations at the peak of the compute dtype and
the bytes at the memory rate.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM, NVIDIA's data sheet: float32 outside the tensor cores,
# bfloat16 on the tensor cores (dense), HBM3
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 67e12, 989e12, 3.35e12


def _get(cfg: Dict, key: str, default):
    value = cfg.get(key, default)
    return default if value is None else value


def peak_flops(cfg: Dict) -> float:
    """The peak of the configuration's compute dtype."""
    return PEAK_BF16_FLOPS if _get(cfg, "compute_dtype", "float32") == "bfloat16" \
        else PEAK_F32_FLOPS


def _width(cfg: Dict) -> int:
    return 2 if _get(cfg, "param_dtype", "float32") == "bfloat16" else 4


def update_flops(cfg: Dict) -> float:
    """Operations of one update: 2*rows*V*H for every product the run needs
    (the hidden phase from the data, a visible and a hidden phase per Gibbs
    step on all chain rows, the data chain's reconstruction under PCD, the
    ladder's log p*(h) inputs under tempering, learned variance's W h0p and
    W hmean, the two gradient products). The swap rounds' and the monitors'
    elementwise work is under 2% of it and left out."""
    B, V, H = cfg["batch_size"], cfg["n_visible"], cfg["n_hidden"]
    k, temps = _get(cfg, "k", 1), _get(cfg, "pt_temps", 1)
    CR = B * max(temps, 1)
    rows = B + 2 * k * CR + 2 * B
    rows += B if _get(cfg, "persistent", False) and _get(cfg, "error_metric", "mse") != "pseudo" \
        else 0
    rows += CR if temps > 1 else 0
    rows += 2 * B if _get(cfg, "learn_variance", False) else 0
    return 2.0 * rows * V * H


def bound(cfg: Dict, updates: int, l2_bytes: int) -> Tuple[float, str]:
    """(seconds, what bounds it) of one launch of ``updates`` updates. Bytes,
    at the storage width: each update's minibatch read once; b, c, z, their
    velocities and the chain read and written once; W read and written once;
    W's velocity written once, and read once only under momentum. What of W,
    and then of its velocity, the L2 cannot hold between updates moves once
    per update instead."""
    B, V, H = cfg["batch_size"], cfg["n_visible"], cfg["n_hidden"]
    width = _width(cfg)
    w = V * H * width
    momentum = _get(cfg, "momentum", 0.0) != 0 or cfg.get("initial_momentum") is not None
    vel_moves = 2 if momentum else 1
    rest = (2 * (V + H) + (2 * V if _get(cfg, "learn_variance", False) else 0)
            + B * max(_get(cfg, "pt_temps", 1), 1) * H) * width
    keep_w = min(w, l2_bytes)
    keep_vel = min(w, l2_bytes - keep_w)
    once = 2 * keep_w + vel_moves * keep_vel + 2 * rest
    per_update = 2 * (w - keep_w) + vel_moves * (w - keep_vel)
    moved = updates * B * V * width + once + updates * per_update
    ops_s = update_flops(cfg) * updates / peak_flops(cfg)
    bytes_s = moved / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def slot_bytes(cfg: Dict, rows: int) -> int:
    """Bytes of a rank's factors in a W-blocked data-parallel step of ``rows``
    rows: the negative-phase visibles at the storage width, the two float32
    h-matrices and the monitor (the program's slot pads these; the padding is
    left out, so the bounds below never read high)."""
    return rows * cfg["n_visible"] * _width(cfg) + 2 * rows * cfg["n_hidden"] * 4 + 4


def wide_step_bound(cfg: Dict, ndev: int) -> Tuple[float, str]:
    """(seconds, what bounds it) of one W-blocked data-parallel step on a
    rank's ceil(B / ndev) rows: operations 2*rows*V*H for the hidden phase from
    the data, a visible and a hidden phase per Gibbs step and, under PCD, the
    data chain's reconstruction; bytes: W, b, c and v0 read (the chain read and
    written under PCD) at the storage width, and the rank's factors written."""
    B = -(-cfg["batch_size"] // ndev)
    V, H, k = cfg["n_visible"], cfg["n_hidden"], _get(cfg, "k", 1)
    persistent = _get(cfg, "persistent", False)
    rows = B + 2 * k * B + (B if persistent else 0)
    ops_s = 2.0 * rows * V * H / peak_flops(cfg)
    moved = _width(cfg) * (V * H + V + H + B * V + (2 * B * H if persistent else 0))
    bytes_s = (moved + slot_bytes(cfg, B)) / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def wide_update_bound(cfg: Dict, ndev: int) -> Tuple[float, str]:
    """(seconds, what bounds it) of one W-blocked data-parallel update over
    ``ndev`` ranks' factors: operations 4*B*V*H for gW's two products at the
    peak of the compute dtype and six per element of W, b and c at the float32
    peak; bytes: W, b and c read and written and their velocities written (and
    read under momentum) at the storage width, v0 read, every rank's factors
    read."""
    B, V, H = cfg["batch_size"], cfg["n_visible"], cfg["n_hidden"]
    n = V * H + V + H
    ops_s = 4.0 * B * V * H / peak_flops(cfg) + 6.0 * n / PEAK_F32_FLOPS
    momentum = _get(cfg, "momentum", 0.0) != 0 or cfg.get("initial_momentum") is not None
    vel_moves = 2 if momentum else 1
    moved = _width(cfg) * ((2 + vel_moves) * n + B * V) + ndev * slot_bytes(cfg, -(-B // ndev))
    bytes_s = moved / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"
