"""Philox4x32-10 draws keyed as the CUDA kernels of the measured program key them.

A draw of kind ``kind`` at Gibbs step ``t`` for element (``row``, ``col``) of
update ``upd`` under the run's 64-bit ``seed`` is the first word of
Philox4x32-10 on the counter (col, row, (t >> 8) << 10 | kind << 8 | (t & 255),
upd) with the key (low and high 32 bits of the seed), and the uniform is its
low 23 bits over 2**23. Kinds: 0 the hidden draw from the data, 1 a hidden
draw of a Gibbs step, 2 a visible draw, 3 a swap. Every product is split into
16-bit halves, so no int64 operation overflows, on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
KIND_H0, KIND_H, KIND_V, KIND_SWAP = 0, 1, 2, 3


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a * m for 32-bit ``a`` (int64 tensor) and ``m``."""
    al, ah = a & 0xFFFF, a >> 16
    ml, mh = m & 0xFFFF, m >> 16
    ll = al * ml
    mid = al * mh + ah * ml + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (ah * mh + (mid >> 16)) & MASK
    return hi, lo


def philox4x32_10(x, y, z, w, seed: int = 0, key=None):
    """The four output words for counter words ``x, y, z, w`` (int64 tensors or
    ints, broadcast together) under the 64-bit ``seed``, or under ``key``, a
    pair of int64 tensors of 32-bit words that broadcast with the counter."""
    k0, k1 = (seed & MASK, (seed >> 32) & MASK) if key is None else key
    x, y, z, w = (torch.as_tensor(v, dtype=torch.int64) for v in (x, y, z, w))
    for _ in range(10):
        hi0, lo0 = _mulhilo(x, _M0)
        hi1, lo1 = _mulhilo(z, _M1)
        x, y, z, w = hi1 ^ y ^ k0, lo1, hi0 ^ w ^ k1, lo0
        k0, k1 = (k0 + _W0) & MASK, (k1 + _W1) & MASK
    return x, y, z, w


def uniforms(seeds, upd, kind: int, t: int, rows: int, cols: int,
             device=None) -> torch.Tensor:
    """float32 uniforms [n, rows, cols]: block i under the 64-bit seed
    ``seeds[i]`` (a list of ints, or one for every block) at update ``upd[i]``
    (an int, or a sequence of n)."""
    upd = torch.as_tensor(upd, dtype=torch.int64, device=device).reshape(-1, 1, 1)
    k0 = torch.tensor([s & MASK for s in seeds], dtype=torch.int64, device=device)
    k1 = torch.tensor([(s >> 32) & MASK for s in seeds], dtype=torch.int64, device=device)
    row = torch.arange(rows, dtype=torch.int64, device=device).reshape(1, -1, 1)
    col = torch.arange(cols, dtype=torch.int64, device=device).reshape(1, 1, -1)
    word = ((t >> 8) << 10) | (kind << 8) | (t & 255)
    x, _, _, _ = philox4x32_10(col, row, word, upd, key=(k0.reshape(-1, 1, 1),
                                                        k1.reshape(-1, 1, 1)))
    return (x & 0x7FFFFF).to(torch.float32) / float(1 << 23)
