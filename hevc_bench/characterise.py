"""Spatial and temporal information (ITU-T P.910) of a traffic mix's content.

    python3 -m hevc_bench.characterise --mix pan --seed 1 --frames 25
        [--size 1920x1080]

SI is the largest over frames of the spatial standard deviation of the
Sobel magnitude of the luma, the outermost rows and columns left out; TI
the largest over frames of the spatial standard deviation of the luma's
difference from the previous frame (P.910, section 5.3). Prints both, with
their means over frames, as one JSON line. The runs do not call it: it
puts the generated content on the scale that published characterisations
of camera sequences use.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

SOBEL_X = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])


def si_frame(y: torch.Tensor) -> float:
    """Spatial std of the Sobel magnitude of one [H, W] luma plane, over
    the (H - 2) x (W - 2) samples whose 3x3 neighbourhood lies inside."""
    k = torch.stack((SOBEL_X, SOBEL_X.t()))[:, None].to(y.device)
    g = F.conv2d(y.to(torch.float64)[None, None], k.to(torch.float64))[0]
    return float(g.pow(2).sum(0).sqrt().std(unbiased=False))


def ti_frame(y: torch.Tensor, prev: torch.Tensor) -> float:
    """Spatial std of the difference of two [H, W] luma planes."""
    return float((y.to(torch.float64) - prev.to(torch.float64))
                 .std(unbiased=False))


def si_ti(lumas):
    """{si_max, si_mean, ti_max, ti_mean} of a sequence of luma planes."""
    si = [si_frame(y) for y in lumas]
    ti = [ti_frame(b, a) for a, b in zip(lumas, lumas[1:])]
    return {"si_max": max(si), "si_mean": sum(si) / len(si),
            "ti_max": max(ti) if ti else None,
            "ti_mean": sum(ti) / len(ti) if ti else None}


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from hevc_bench.content import Content
    from hevc_bench.harness import HERE, load_json
    ap = argparse.ArgumentParser(prog="hevc_bench.characterise")
    ap.add_argument("--mix", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--size", default="1920x1080")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.split("x"))
    content = Content(load_json(HERE, "traffic", args.mix + ".json"), w, h,
                      args.seed)
    lumas = [torch.from_numpy(content.frame(i)[0])
             for i in range(args.frames)]
    print(json.dumps(dict(mix=args.mix, seed=args.seed, frames=args.frames,
                          size=args.size, **si_ti(lumas))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
