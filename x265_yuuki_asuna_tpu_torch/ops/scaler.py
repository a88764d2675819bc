"""Video scaler: a separable fixed-point polyphase resize (the ABR
ladder's; reference analog: the scaler of x265's abrEncApp).

Port of x265_yuuki_asuna_tpu/ops/scaler.py, equal to its numpy path
sample for sample at every bit depth: a Catmull-Rom (a = -0.5) kernel
sampled at 32 phases, 4 taps of 7-bit coefficients whose sum is exactly
128 (the DC gain is one), centre-aligned source positions, edge
replication at the borders; the width first, then the height, each
pass rounding (+64 >> 7) without a clip between them, the clip to the
bit depth's range last. Chroma planes scale to half the luma geometry.

The filter bank and, per (source, destination) size, each output
sample's source index and phase are host tables computed in float64 as
numpy computes them (so floor and the phase round alike); the taps'
multiply-accumulate runs in int32 on the planes' device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

PHASES = 32
TAPS = 4
PREC = 7           # coefficient fixed-point bits


def _cubic(x: float, a: float = -0.5) -> float:
    x = abs(x)
    if x < 1.0:
        return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
    if x < 2.0:
        return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
    return 0.0


def _filter_bank() -> np.ndarray:
    """[PHASES, TAPS] int32 coefficients summing to 1 << PREC per phase
    (the rounding error goes to the second tap)."""
    bank = np.zeros((PHASES, TAPS), np.int32)
    for p in range(PHASES):
        frac = p / PHASES
        w = np.array([_cubic(frac + 1), _cubic(frac), _cubic(1 - frac),
                      _cubic(2 - frac)])
        w = w / w.sum()
        q = np.round(w * (1 << PREC)).astype(np.int32)
        q[1] += (1 << PREC) - q.sum()
        bank[p] = q
    return bank


BANK = _filter_bank()


@lru_cache(maxsize=None)
def _taps(src: int, dst: int):
    """(indices [dst, TAPS], coefficients [dst, TAPS]) int32 of a
    src -> dst resize: each output sample's centre-aligned source
    position in float64, its floor and nearest phase, the four source
    samples around it clamped to the plane (edge replication)."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    base = np.floor(pos).astype(np.int32)
    phase = np.clip((((pos - base) * PHASES) + 0.5).astype(np.int32), 0,
                    PHASES - 1)
    idx = np.clip(base[:, None] + np.arange(-1, TAPS - 1)[None, :], 0,
                  src - 1)
    return idx.astype(np.int64), BANK[phase]


def _resize_axis(plane: torch.Tensor, dst: int) -> torch.Tensor:
    """Resize the last axis of an int32 tensor to dst samples."""
    src = plane.shape[-1]
    if dst == src:
        return plane
    idx, coef = _taps(src, dst)
    dev = plane.device
    g = plane[..., torch.as_tensor(idx, device=dev)]      # [..., dst, TAPS]
    acc = (g * torch.as_tensor(coef, device=dev)).sum(-1, dtype=torch.int32)
    return (acc + (1 << (PREC - 1))) >> PREC


def resize_plane(plane, dst_h: int, dst_w: int, bit_depth: int = 8,
                 device="cpu") -> torch.Tensor:
    """Resize one [H, W] plane (or a batch [..., H, W]; numpy or a
    tensor) to dst_h x dst_w: an int32 tensor on `device` (a tensor
    input stays on its own), clipped to the bit depth's range."""
    if not isinstance(plane, torch.Tensor):
        plane = torch.as_tensor(np.ascontiguousarray(plane), device=device)
    p = _resize_axis(plane.to(torch.int32), dst_w)
    p = _resize_axis(p.transpose(-1, -2), dst_h).transpose(-1, -2)
    return p.clamp(0, (1 << bit_depth) - 1)


def resize_frame(y, u, v, dst_w: int, dst_h: int, bit_depth: int = 8,
                 device="cpu"):
    """Resize a 4:2:0 frame of host planes on `device`: (y, u, v) host
    arrays of y's dtype, chroma at half the luma geometry."""
    dt = np.asarray(y).dtype
    out = (resize_plane(y, dst_h, dst_w, bit_depth, device),
           resize_plane(u, dst_h // 2, dst_w // 2, bit_depth, device),
           resize_plane(v, dst_h // 2, dst_w // 2, bit_depth, device))
    return tuple(p.cpu().numpy().astype(dt) for p in out)
