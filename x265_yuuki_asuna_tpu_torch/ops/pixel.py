"""Pixel cost metrics: SATD (4x4 Hadamard), sa8d (8x8 Hadamard), the
psycho-visual energy, SSIM.

Port of x265_yuuki_asuna_tpu/ops/pixel.py (satd, satd4, sa8d,
psy_energy, ssim_plane).
Reference behavior (studied, not copied): common/pixel.cpp satd_4x4 —
sum(|H d H|) / 2 with rounding; sa8d_8x8 — (sum(|H d H|) + 2) >> 2;
rdcost.h psyCost — the block's AC energy.

Exactness: the Hadamard products run in float64 (CUDA has no int32
matmul); entries are +-1 and |d| <= 2^16, so every partial sum is an
integer far below 2^53 and the result is exact in any summation order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def peak(bit_depth: int) -> int:
    """The largest sample value at a bit depth."""
    return (1 << bit_depth) - 1


def plane_dtype(bit_depth: int) -> torch.dtype:
    """The type of sample planes kept on the device: uint8 at 8 bits,
    int16 above (12 bits fit; torch has few uint16 ops). K1 takes
    both."""
    return torch.uint8 if bit_depth <= 8 else torch.int16


def hadamard_matrix(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


@lru_cache(maxsize=None)
def _hadamard_t(n: int, device) -> torch.Tensor:
    """The Hadamard matrix as float64 on `device`, made once (a host copy
    per call would make the host wait for the card's stream)."""
    return torch.as_tensor(hadamard_matrix(n), dtype=torch.float64,
                           device=device)


def _hadamard2d(blocks: torch.Tensor, n: int) -> torch.Tensor:
    H = _hadamard_t(n, blocks.device)
    return (H @ blocks.to(torch.float64) @ H).to(torch.int64)


def satd4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SATD over 4x4 blocks [..., 4, 4] -> int64 [...]."""
    d = a.to(torch.int32) - b.to(torch.int32)
    h = _hadamard2d(d, 4)
    return (h.abs().sum(dim=(-2, -1)) + 1) >> 1


def _tile(blocks: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """[..., H, W] -> [..., H//th, W//tw, th, tw]"""
    shp = blocks.shape
    H, W = shp[-2], shp[-1]
    r = blocks.reshape(shp[:-2] + (H // th, th, W // tw, tw))
    return r.transpose(-3, -2)


def satd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SATD of [..., H, W] blocks (H, W multiples of 4): the sum of the
    4x4-subblock SATDs. Broadcasts a against b. Returns int32 [...]."""
    per = satd4(_tile(a, 4, 4), _tile(b, 4, 4))
    return per.sum(dim=(-2, -1)).to(torch.int32)


def sa8d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sa8d of [..., H, W] blocks (H, W multiples of 8): the sum over the
    8x8 subblocks of (sum(|H d H|) + 2) >> 2. Returns int32 [...]."""
    d = _tile(a, 8, 8).to(torch.int32) - _tile(b, 8, 8).to(torch.int32)
    per = (_hadamard2d(d, 8).abs().sum(dim=(-2, -1)) + 2) >> 2
    return per.sum(dim=(-2, -1)).to(torch.int32)


def psy_energy(a: torch.Tensor) -> torch.Tensor:
    """Psycho-visual energy of [..., N, N] pixel blocks (N a multiple of
    8): the sa8d of each block against its DC, the floor of its mean (the
    reference's float32 mean, exact below 2^24, then truncated). Returns
    int32 [...]."""
    ai = a.to(torch.int32)
    n = ai.shape[-1] * ai.shape[-2]
    dc = torch.div(ai.sum(dim=(-2, -1), dtype=torch.int64), n,
                   rounding_mode="floor").to(torch.int32)
    return sa8d(ai, dc[..., None, None].expand(ai.shape))



def ssim_plane(a: np.ndarray, b: np.ndarray, device,
               bit_depth: int = 8) -> float:
    """Global SSIM of two planes of bit_depth-bit samples (the constants
    from its peak) over 8x8 windows at a stride of 4
    (port of the reference's ssim_plane: integral-image window sums, the
    mean of the per-window SSIMs). The window sums are integers, exact in
    float64 in any order, so they run on `device`; the per-window values
    follow the reference's float64 expression op for op, and their mean
    is numpy's (pairwise) on the host, so the result equals the
    reference's bit for bit."""
    L = peak(bit_depth)
    c1 = (0.01 * L) ** 2
    c2 = (0.03 * L) ** 2
    H, W = a.shape
    if H < 8 or W < 8:
        return 1.0
    t = lambda p: torch.as_tensor(np.ascontiguousarray(p)).to(
        device=device, dtype=torch.float64)
    a, b = t(a), t(b)

    def win_sums(x):
        ii = torch.zeros((H + 1, W + 1), dtype=torch.float64, device=device)
        ii[1:, 1:] = x.cumsum(0).cumsum(1)
        return (ii[8:H + 1:4, 8:W + 1:4] - ii[8:H + 1:4, 0:W - 7:4]
                - ii[0:H - 7:4, 8:W + 1:4] + ii[0:H - 7:4, 0:W - 7:4])

    n = 64.0
    ma, mb = win_sums(a) / n, win_sums(b) / n
    va = win_sums(a * a) / n - ma * ma
    vb = win_sums(b * b) / n - mb * mb
    cov = win_sums(a * b) / n - ma * mb
    vals = (((2 * ma * mb + c1) * (2 * cov + c2))
            / ((ma * ma + mb * mb + c1) * (va + vb + c2)))
    return float(vals.cpu().numpy().mean())
