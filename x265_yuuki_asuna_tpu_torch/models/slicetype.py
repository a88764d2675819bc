"""cuTree's propagation over a decided lookahead window.

Port of x265_yuuki_asuna_tpu/models/slicetype.py (_bilinear_scatter,
cutree_propagate, pool_to_cu), numpy on the host. The scatter adds float64
amounts with np.add.at in index order; an unordered device scatter could
round differently, move a log2 and flip a rounded offset, so the
propagation stays here. At 1080p it walks about 8k lowres blocks per
window frame.

Reference behavior (studied, not copied): encoder/slicetype.cpp cuTree /
estimateCUPropagate walk the window backwards, pushing each frame's cost
along its lowres motion into the frame it predicts from; the frame about
to be coded lowers its QP where much future cost lands
(computeCUTreeQpOffset: -strength * log2((intra + propagate_in) / intra)).
"""

from __future__ import annotations

from typing import List

import numpy as np


def _bilinear_scatter(acc: np.ndarray, amount: np.ndarray,
                      mvx: np.ndarray, mvy: np.ndarray) -> None:
    """Area-weighted scatter of each block's `amount` into `acc`, displaced
    by the lowres MVs (the four corners of estimateCUPropagate)."""
    nby, nbx = acc.shape
    bx = np.arange(nbx) * 8
    by = np.arange(nby) * 8
    gx = (bx[None, :] + mvx) / 8.0
    gy = (by[:, None] + mvy) / 8.0
    x0 = np.floor(gx).astype(int)
    y0 = np.floor(gy).astype(int)
    fx = gx - x0
    fy = gy - y0
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                      (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        np.add.at(acc, (np.clip(y0 + dy, 0, nby - 1),
                        np.clip(x0 + dx, 0, nbx - 1)), amount * w)


def cutree_propagate(details: List[dict], strength: float = 2.0,
                     max_offset: float = 6.0) -> np.ndarray:
    """Per-lowres-block QP offsets (nby, nbx), <= 0, of details[0], the
    frame about to be coded, from the window details[1:] after it (each
    predicting from the one before it). A detail is the lookahead's
    last_detail of its frame (icost, sad, mvx, mvy per lowres block,
    has_prev, nb_x, nb_y) with "scenecut": no propagation across a frame
    without a previous one or at a scenecut."""
    if not details:
        raise ValueError("empty lookahead window")
    nbx, nby = details[0]["nb_x"], details[0]["nb_y"]
    prop = np.zeros((nby, nbx), np.float64)   # propagate_in of frame i
    for i in range(len(details) - 1, 0, -1):
        d = details[i]
        nxt = np.zeros((nby, nbx), np.float64)
        if d.get("has_prev", True) and not d.get("scenecut", False):
            icost = np.maximum(
                d["icost"].reshape(nby, nbx).astype(np.float64), 1.0)
            sad = d["sad"].reshape(nby, nbx).astype(np.float64)
            frac = np.clip(1.0 - sad / icost, 0.0, 1.0)
            amount = (icost + prop) * frac
            _bilinear_scatter(nxt, amount, d["mvx"].reshape(nby, nbx),
                              d["mvy"].reshape(nby, nbx))
        prop = nxt
    d0 = details[0]
    icost0 = np.maximum(d0["icost"].reshape(nby, nbx).astype(np.float64),
                        1.0)
    off = -strength * np.log2((icost0 + prop) / icost0)
    return np.clip(off, -max_offset, 0.0)


def pool_to_cu(off_blk: np.ndarray, cu_size: int, rows: int,
               cols: int) -> np.ndarray:
    """The mean of the lowres-block (= full-res 16x16) offsets over each
    CU, rounded: [rows, cols] int32 (0 where no block covers a CU)."""
    s = max(cu_size // 16, 1)
    nby, nbx = off_blk.shape
    out = np.zeros((rows, cols))
    for r in range(rows):
        rs = off_blk[r * s:min((r + 1) * s, nby)]
        if rs.size == 0:
            continue
        for c in range(cols):
            blk = rs[:, c * s:min((c + 1) * s, nbx)]
            if blk.size:
                out[r, c] = blk.mean()
    return np.round(out).astype(np.int32)
