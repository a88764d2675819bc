"""HEVC core transforms (DCT-II 4/8/16/32) as batched matrix products.

Port of x265_yuuki_asuna_tpu/ops/transforms.py (forward/inverse transform).
Reference behavior (studied, not copied): common/dct.cpp
  - forward shifts:  shift1 = log2N - 1 + (bitDepth - 8), shift2 = log2N + 6
  - inverse shifts:  shift1 = 7, shift2 = 12 - (bitDepth - 8), int16 clamp
    after each stage

Exactness: CUDA has no int32 matmul, so each stage multiplies in float64.
Every product and partial sum is an integer of magnitude below 2^31 (the
worst case is 32 taps x 90 x 32767 ~ 9.4e7), far under float64's 2^53, so
the float64 product is the exact integer sum in any summation order, on
the CPU and on the card alike. The rounding shift then runs on int64.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

# The complete set of coefficient magnitudes in the HEVC DCT matrices
# (H.265 sec 8.6.4.2).
_SPEC_MAGNITUDES = np.array(
    [4, 9, 13, 18, 22, 25, 31, 36, 38, 43, 46, 50, 54, 57, 61, 64,
     67, 70, 73, 75, 78, 80, 82, 83, 85, 87, 88, 89, 90], dtype=np.float64)


@lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """The n-point HEVC integer DCT matrix (n in 4/8/16/32), int32 [n, n]."""
    assert n in (4, 8, 16, 32)
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    ideal = 64.0 * math.sqrt(2.0) * np.cos(np.pi * k * (2 * m + 1) / (2 * n))
    signs = np.sign(ideal)
    signs[np.abs(ideal) < 1e-9] = 0.0
    mags = np.abs(ideal)
    snapped = _SPEC_MAGNITUDES[np.argmin(
        np.abs(mags[..., None] - _SPEC_MAGNITUDES[None, None, :]), axis=-1)]
    out = (signs * snapped).astype(np.int32)
    out[0, :] = 64  # DC row is exactly 64
    return out


@lru_cache(maxsize=None)
def _t64(n: int, device) -> torch.Tensor:
    """The DCT matrix as float64 on `device`, made once: a host copy in
    every transform would make the host wait for the card's stream."""
    return torch.as_tensor(dct_matrix(n), dtype=torch.float64, device=device)


def _round_shift(prod: torch.Tensor, shift: int) -> torch.Tensor:
    return (prod.to(torch.int64) + (1 << (shift - 1))) >> shift


def forward_transform(blocks: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """Forward 2D DCT of residual blocks [..., N, N] -> int32 coefficients.

    Each stage is out[..., k, j] = (sum_n T[k, n] * in[..., j, n] + add)
    >> shift, i.e. T @ in^T (transforms along the last axis and transposes).
    """
    n = int(blocks.shape[-1])
    T = _t64(n, blocks.device)
    log2n = n.bit_length() - 1
    t = _round_shift(T @ blocks.to(torch.float64).transpose(-1, -2),
                     log2n - 1 + (bit_depth - 8))
    c = _round_shift(T @ t.to(torch.float64).transpose(-1, -2), log2n + 6)
    return c.to(torch.int32)


def inverse_transform(coeffs: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """Inverse 2D DCT: coefficients [..., N, N] -> int32 residual.

    Each stage is out[..., j, n] = clip16((sum_k T[k, n] * in[..., k, j]
    + add) >> shift), i.e. in^T @ T."""
    n = int(coeffs.shape[-1])
    T = _t64(n, coeffs.device)
    t = _round_shift(coeffs.to(torch.float64).transpose(-1, -2) @ T, 7)
    t = t.clamp(-32768, 32767)
    r = _round_shift(t.to(torch.float64).transpose(-1, -2) @ T,
                     12 - (bit_depth - 8))
    return r.clamp(-32768, 32767).to(torch.int32)
