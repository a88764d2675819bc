"""Motion estimation: full-search SAD over a +-R window for every block.

Port of x265_yuuki_asuna_tpu/ops/me.py (sad_sweep_multi, sad_at_mv,
full_search_sad) on K1 (`kernels/me_sad`). A single block size of 8 or 16
takes the fused sweep-and-argmin kernel, which writes no surface; several
sizes take the surface kernel (the 8x8 SAD of every displacement) and the
plain PyTorch aggregation, rate bias and argmin.

Cost = SAD + lambda_bits * (|dx| + |dy|); ties go to the first (dy, dx) in
row-major order.
"""

from __future__ import annotations

import torch

from .kernels import me_sad


def sad_sweep_multi(ref_plane: torch.Tensor, src_plane: torch.Tensor, sizes,
                    srange: int, lambda_bits: int = 1) -> dict:
    """Frame-level full-search ME for the aligned block sizes in `sizes`
    (multiples of 8). ref/src: [H, W] planes, H and W multiples of
    max(sizes). Returns {n: (mvx, mvy, sad)} int32 arrays in raster block
    order."""
    sizes = sorted(sizes)
    assert sizes[0] % 8 == 0, sizes
    if len(sizes) == 1 and sizes[0] in me_sad.BEST_SIZES:
        n = sizes[0]
        return {n: me_sad.sad_sweep_best(ref_plane, src_plane, srange, n,
                                         lambda_bits)}
    s8 = me_sad.sad_block8_sweep(ref_plane, src_plane, srange)
    return {n: me_sad.best_of_surface(s8, n, srange, lambda_bits)
            for n in sizes}


def sad_at_mv(ref_plane: torch.Tensor, src_blocks: torch.Tensor, px, py,
              mvx, mvy, n: int) -> torch.Tensor:
    """SAD of each block against the reference at a given integer MV
    (border-clamped). Returns int32 [B]."""
    H, W = ref_plane.shape
    ar = torch.arange(n, device=ref_plane.device)
    rows = ((py + mvy).long()[:, None] + ar[None, :]).clamp(0, H - 1)
    cols = ((px + mvx).long()[:, None] + ar[None, :]).clamp(0, W - 1)
    win = ref_plane.reshape(-1)[rows[:, :, None] * W + cols[:, None, :]]
    d = (win.to(torch.int32) - src_blocks.to(torch.int32)).abs()
    return d.sum(dim=(-2, -1)).to(torch.int32)


def full_search_sad(ref_plane: torch.Tensor, src_plane: torch.Tensor, n: int,
                    srange: int, lambda_bits: int = 1):
    """Integer full search for every n x n block of the uniform grid of
    `src_plane`: (mvx, mvy, sad) [B] over all MVs in [-R, R]^2 on the
    border-clamped reference.

    The JAX package's full_search_sad takes the grid's blocks and their
    positions and gathers a [B, D, D, n, n] candidate tensor; on the uniform
    grid it computes exactly the sweep with sizes=(n,) (edge extension
    equals its border clamp, and both take the first minimum in (dy, dx)
    order), so the port runs it through K1's fused kernel on the plane."""
    return sad_sweep_multi(ref_plane, src_plane, (n,), srange, lambda_bits)[n]
