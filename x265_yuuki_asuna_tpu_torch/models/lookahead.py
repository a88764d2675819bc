"""Lookahead: half-res cost estimation, scenecut detection and the b-adapt
costs.

Port of x265_yuuki_asuna_tpu/models/lookahead.py (downscale_half, the
per-frame pass and push with the histogram scene cut, pair_cost,
bidir_cost, badapt_path_costs). Every sweep is K1's fused sweep-and-argmin
at n=8, R=16, lambda_bits=1 on the lowres planes in the device plane type
(uint8 at 8 bits, int16 above: downscale_half keeps the samples' range),
which stay on the device.

As in the reference, the histogram scene cut bins low >> 2 into 64 bins
whatever the bit depth, so above 8 bits it counts only the lowres samples
below 256 (ROADMAP Queue 3).

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


HIST_CUT = 0.35       # the histogram scene cut's L1 distance


def _search(ref_low: torch.Tensor, cur_low: torch.Tensor,
            bd: int = 8) -> torch.Tensor:
    """[nblocks] SAD of each 8x8 lowres block of cur at its best MV into
    ref (full search +-16, lambda_bits 1): K1's fused kernel on the
    planes in the device plane type of bd-bit samples (exact: downscale_half
    stays within the bit depth's range)."""
    dt = pixel.plane_dtype(bd)
    return me.sad_sweep_multi(ref_low.to(dt), cur_low.to(dt), (8,), 16,
                              lambda_bits=1, peak=pixel.peak(bd))[8][2]


class Lookahead:
    """Incremental lookahead over a session's frames (one L0 reference).
    hist_scenecut: the histogram rule replaces the cost rule (the
    reference's bHistBasedSceneCut)."""

    def __init__(self, width: int, height: int, device,
                 hist_scenecut: bool = False, bit_depth: int = 8):
        # lowres geometry, trimmed to whole 8x8 blocks
        self.lw = (width // 2) // 8 * 8
        self.lh = (height // 2) // 8 * 8
        self.device = torch.device(device)
        self.bd = bit_depth
        self.hist_scenecut = hist_scenecut
        self._prev_hist = None
        self.prev_lowres = None       # int32 [lh, lw] on the device
        self.last_detail = None

    def _blocks(self, low: torch.Tensor) -> torch.Tensor:
        """[nblocks, 8, 8] raster 8x8 blocks of a lowres plane."""
        nb_x, nb_y = self.lw // 8, self.lh // 8
        return (low.reshape(nb_y, 8, nb_x, 8).permute(0, 2, 1, 3)
                .reshape(nb_x * nb_y, 8, 8))

    @staticmethod
    def _icost(blocks: torch.Tensor) -> torch.Tensor:
        """Lowres intra estimate of each block: SATD against the DC
        predictor; the DC is the integer block sum // 64 (the JAX float
        mean truncates to the same value: sums <= 64*4095 are exact in
        float32)."""
        nblocks = blocks.shape[0]
        dc = blocks.reshape(nblocks, 64).sum(dim=1) // 64
        return pixel.satd(blocks, dc.to(torch.int32)[:, None, None]
                          .expand(nblocks, 8, 8))

    def _run(self, y: torch.Tensor, prev: torch.Tensor, has_prev: bool):
        lw, lh = self.lw, self.lh
        nb_x, nb_y = lw // 8, lh // 8
        nblocks = nb_x * nb_y
        dev = self.device
        low = downscale_half(y)[:lh, :lw].contiguous()
        blocks = self._blocks(low)
        icost = self._icost(blocks)
        intra_cost = icost.sum()
        # lowres inter: 8x8 full search +-16 on the previous lowres (K1's
        # fused kernel, as _search)
        dt = pixel.plane_dtype(self.bd)
        mvx, mvy, sad = me.sad_sweep_multi(prev.to(dt), low.to(dt), (8,), 16,
                                           lambda_bits=1,
                                           peak=pixel.peak(self.bd))[8]
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

    def pair_cost(self, ref_low: torch.Tensor, cur_low: torch.Tensor) \
            -> float:
        """Lowres ME cost of cur against an arbitrary reference: the sum
        over blocks of min(SAD, intra) (distance-aware fast b-adapt)."""
        icost = self._icost(self._blocks(cur_low))
        return float(torch.minimum(_search(ref_low, cur_low, self.bd),
                                   icost).sum())

    def bidir_cost(self, ref0_low: torch.Tensor, ref1_low: torch.Tensor,
                   cur_low: torch.Tensor) -> float:
        """Cost of cur as a B between ref0 (past) and ref1 (future): the
        sum over blocks of min(forward SAD, backward SAD, intra)."""
        icost = self._icost(self._blocks(cur_low))
        fwd, bwd = (_search(r, cur_low, self.bd) for r in (ref0_low,
                                                           ref1_low))
        return float(torch.minimum(torch.minimum(fwd, bwd), icost).sum())

    def badapt_path_costs(self, anchor_low: torch.Tensor, lows) \
            -> np.ndarray:
        """The b-adapt trellis over the K pending lowres planes `lows`:
        the cost of each P placement k, cost(anchor -> P at lows[k]) plus
        the bidir cost of every lows[i], i < k, between the anchor and
        lows[k], divided by k + 1 (float64 [K]). The K forward sweeps
        run first, then the K(K-1)/2 backward ones in the reference's
        (k, i < k) order; the per-term int sums are combined on the host
        in the reference's order."""
        K = len(lows)
        icost = [self._icost(self._blocks(c)) for c in lows]
        dt = pixel.plane_dtype(self.bd)
        anchor_low = anchor_low.to(dt)
        lows = [c.to(dt) for c in lows]
        fwd = [_search(anchor_low, c, self.bd) for c in lows]
        terms = [torch.minimum(f, ic).sum() for f, ic in zip(fwd, icost)]
        for k in range(K):
            for i in range(k):
                bwd = _search(lows[k], lows[i], self.bd)
                terms.append(torch.minimum(torch.minimum(fwd[i], bwd),
                                           icost[i]).sum())
        raw = torch.stack(terms).cpu().numpy().astype(np.int64)
        cost = raw[:K].astype(np.float64)
        p = K
        for k in range(K):
            for _ in range(k):
                cost[k] += float(raw[p])
                p += 1
        return cost / (np.arange(K) + 1.0)

    def _hist_cut(self, low: torch.Tensor) -> bool:
        """The histogram scene cut: the L1 distance of this frame's
        normalised 64-bin histogram of low >> 2 from the previous frame's
        above HIST_CUT (never on the first frame). The bins stop at 64 at
        every bit depth, as in the reference: deeper samples from 256 up
        fall out of the histogram."""
        hist = torch.bincount(low.reshape(-1) >> 2, minlength=64)[:64] \
            .cpu().numpy().astype(np.float64)
        hist /= max(hist.sum(), 1.0)
        cut = self._prev_hist is not None and \
            float(np.abs(hist - self._prev_hist).sum()) > HIST_CUT
        self._prev_hist = hist
        return cut

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
        if self.hist_scenecut:
            scenecut = self._hist_cut(low)
        return icost, pcost, bool(scenecut)
