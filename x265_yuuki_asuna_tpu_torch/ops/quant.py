"""Quantization / dequantization with flat scaling lists, batched.

Port of x265_yuuki_asuna_tpu/ops/quant.py (quant, dequant). The QP is a
Python int (one QP for the call) or an int tensor [B] (one QP per block
of a [B, N, N] batch, as the quadtree programs pass it).
Reference behavior (studied, not copied): common/dct.cpp quant_c /
dequant_normal_c, common/quant.cpp shift derivations:
    transformShift = 15 - bitDepth - log2N
    qbits   = 14 + qp // 6 + transformShift
    dqshift = 20 - 14 - transformShift
All arithmetic is elementwise int32 (|coef| * scale < 2^30).
"""

from __future__ import annotations

import torch

# Spec constants (H.265 sec 8.6.3)
QUANT_SCALES = (26214, 23302, 20560, 18396, 16384, 14564)
INV_QUANT_SCALES = (40, 45, 51, 57, 64, 72)


def transform_shift(log2_tr_size: int, bit_depth: int) -> int:
    return 15 - bit_depth - log2_tr_size


def _per_rem(qp, scales, like: torch.Tensor):
    """(qp // 6, scales[qp % 6]): ints, or int32 tensors [B, 1, 1]."""
    if isinstance(qp, int):
        return qp // 6, scales[qp % 6]
    q = qp.to(torch.int32).reshape(-1, 1, 1)
    tab = torch.tensor(scales, dtype=torch.int32, device=like.device)
    return q // 6, tab[(q % 6).long()]


def quant(coef: torch.Tensor, qp, log2_tr_size: int,
          bit_depth: int = 8, is_intra_slice: bool = True) -> torch.Tensor:
    """Forward quant with the reference's RDO-less rounding offset
    (171/512 in I slices, 85/512 in P slices): int32 levels [..., N, N]."""
    per, scale = _per_rem(qp, QUANT_SCALES, coef)
    qbits = 14 + per + transform_shift(log2_tr_size, bit_depth)
    add = (171 if is_intra_slice else 85) << (qbits - 9) \
        if isinstance(qbits, int) else \
        torch.full_like(qbits, 171 if is_intra_slice else 85) << (qbits - 9)
    c = coef.to(torch.int32)
    level = (c.abs() * scale + add) >> qbits
    return (level * torch.sign(c)).clamp(-32768, 32767)


def dequant(levels: torch.Tensor, qp, log2_tr_size: int,
            bit_depth: int = 8) -> torch.Tensor:
    """Flat-list dequant (dequant_normal): levels -> int32 coefficients."""
    shift = 20 - 14 - transform_shift(log2_tr_size, bit_depth)
    per, scale = _per_rem(qp, INV_QUANT_SCALES, levels)
    scale = scale << per
    c = (levels.to(torch.int32) * scale + (1 << (shift - 1))) >> shift
    return c.clamp(-32768, 32767)
