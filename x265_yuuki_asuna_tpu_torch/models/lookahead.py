"""Lookahead: half-res cost estimation and scenecut detection.

Port of x265_yuuki_asuna_tpu/models/lookahead.py (downscale_half,
Lookahead._build's per-frame pass, push). The pair / bidir / b-adapt costs
of the B-frame path belong to a later slice.

Reference behavior (studied, not copied): encoder/slicetype.cpp — lowres
pyramid (frameInitLowres), 8x8 lowres ME, lowres intra estimate, scenecut
decision (slicetype.cpp:2229).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import me, pixel

SCENECUT_BIAS = 0.4    # the reference's default scenecut threshold 40


def downscale_half(plane: torch.Tensor) -> torch.Tensor:
    """Half-res box filter (reference frameInitLowres semantics)."""
    p = plane.to(torch.int32)
    h2 = (p.shape[0] // 2) * 2
    w2 = (p.shape[1] // 2) * 2
    p = p[:h2, :w2]
    return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
            + p[1::2, 1::2] + 2) >> 2


class Lookahead:
    """Incremental lookahead over a session's frames (one L0 reference)."""

    def __init__(self, width: int, height: int, device):
        # lowres geometry, trimmed to whole 8x8 blocks
        self.lw = (width // 2) // 8 * 8
        self.lh = (height // 2) // 8 * 8
        self.device = torch.device(device)
        self.prev_lowres = None       # int32 [lh, lw] on the device
        self.last_detail = None

    def _run(self, y: torch.Tensor, prev: torch.Tensor, has_prev: bool):
        lw, lh = self.lw, self.lh
        nb_x, nb_y = lw // 8, lh // 8
        nblocks = nb_x * nb_y
        dev = self.device
        low = downscale_half(y)[:lh, :lw].contiguous()
        blocks = (low.reshape(nb_y, 8, nb_x, 8).permute(0, 2, 1, 3)
                  .reshape(nblocks, 8, 8))
        # lowres intra estimate: SATD against the DC predictor; the DC is
        # the integer block sum // 64 (the JAX float mean truncates to the
        # same value: sums <= 64*255 are exact in float32)
        dc = blocks.reshape(nblocks, 64).sum(dim=1) // 64
        icost = pixel.satd(blocks, dc.to(torch.int32)[:, None, None]
                           .expand(nblocks, 8, 8))
        intra_cost = icost.sum()
        # lowres inter: 8x8 full search +-16 on the previous lowres (K1's
        # fused kernel). The sweep takes uint8 planes: exact, since
        # downscale_half of uint8 stays within 0..255
        mvx, mvy, sad = me.sad_sweep_multi(prev.to(torch.uint8),
                                           low.to(torch.uint8), (8,), 16,
                                           lambda_bits=1)[8]
        # half-pel refinement: a P-px full-res pan is P/2 at lowres
        px = (torch.arange(nblocks, dtype=torch.int32, device=dev) % nb_x) * 8
        py = (torch.arange(nblocks, dtype=torch.int32, device=dev) // nb_x) * 8
        ph = (prev + torch.cat([prev[:, 1:], prev[:, -1:]], dim=1) + 1) >> 1
        pv = (prev + torch.cat([prev[1:, :], prev[-1:, :]], dim=0) + 1) >> 1
        for pl, dx, dy in ((ph, 0, 0), (ph, -1, 0), (pv, 0, 0), (pv, 0, -1)):
            sad = torch.minimum(sad, me.sad_at_mv(pl, blocks, px, py,
                                                  mvx + dx, mvy + dy, 8))
        inter_cost = torch.minimum(sad, icost).sum() if has_prev \
            else intra_cost
        # one packed float32 vector, like the JAX program's output: the
        # frame totals round to float32 exactly as they do there
        packed = torch.cat([
            intra_cost.reshape(1).to(torch.float32),
            inter_cost.reshape(1).to(torch.float32),
            icost.to(torch.float32), sad.to(torch.float32),
            mvx.to(torch.float32), mvy.to(torch.float32)])
        return low, packed

    def push(self, y: np.ndarray):
        """Returns (intra_cost, inter_cost, scenecut) for this frame."""
        has_prev = self.prev_lowres is not None
        prev = self.prev_lowres if has_prev else \
            torch.zeros((self.lh, self.lw), dtype=torch.int32,
                        device=self.device)
        yt = torch.as_tensor(np.ascontiguousarray(y), device=self.device)
        low, packed = self._run(yt, prev, has_prev)
        self.prev_lowres = low
        packed = packed.cpu().numpy()
        nb = (self.lw // 8) * (self.lh // 8)
        icost, pcost = float(packed[0]), float(packed[1])
        # per-block detail (8x8 lowres block == 16x16 full-res CU)
        self.last_detail = {
            "icost": packed[2:2 + nb], "sad": packed[2 + nb:2 + 2 * nb],
            "mvx": packed[2 + 2 * nb:2 + 3 * nb].astype(np.int32),
            "mvy": packed[2 + 3 * nb:2 + 4 * nb].astype(np.int32),
            "has_prev": has_prev,
            "nb_x": self.lw // 8, "nb_y": self.lh // 8,
        }
        # scenecut rule (slicetype.cpp:2229 shape; threshold 40 -> bias
        # 0.4): cut when inter cost stops beating intra by the margin
        scenecut = has_prev and pcost >= (1.0 - SCENECUT_BIAS) * icost \
            and icost > 0
        return icost, pcost, bool(scenecut)
