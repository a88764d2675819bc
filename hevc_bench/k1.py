"""K1, the port's motion-search kernel, seen from outside.

`Recorder` wraps the three entry points of
`x265_yuuki_asuna_tpu_torch.ops.kernels.me_sad` (`sad_sweep_best`,
`sad_block8_sweep`, `sad_block4_sweep`) in the module, so that every
caller reaches the wrapper. For each call it records the shapes (for the
bound below) and the host clock. While `keep` is on (the window) it keeps
a sample of KEPT launches drawn from the seed (a reservoir: every launch
of the window is equally likely to be in it), as copies on the device of
their inputs and answers, for the plain check after the window (`check`):
nothing is read back and nothing waits for the card inside the window.
`fault` plants a test fault in the answers of one launch, which is kept.

`bound_s` is a frozen copy of chip_smoke.py's `k1_bound_ms`: the least
time of a sweep is the larger of its bytes (both planes read once, the
surface or the fused kernel's three int32 outputs written once) over the
memory rate and its abs-diff-adds over the INT32 lanes' rate (four to an
instruction on 8-bit planes).
"""

from __future__ import annotations

import json
import os
import random
import time

import torch

from . import reference

ENTRIES = ("sad_sweep_best", "sad_block8_sweep", "sad_block4_sweep")
SURFACE_SAMPLES = 4096
KEPT = 32
PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def peaks(kind: str):
    """The card's row of the table of peaks, or None for a card it lacks."""
    with open(PEAKS) as f:
        return json.load(f).get(kind)


def bound_s(row: dict, H: int, W: int, R: int, elem: int, n: int = None,
            base: int = 8) -> float:
    """Least seconds of one sweep over H x W planes of `elem`-byte
    samples at range R: the surface of base x base blocks, or with n the
    fused n x n argmin."""
    D = 2 * R + 1
    out = D * D * (H // base) * (W // base) * 4 if n is None \
        else 3 * (H // n) * (W // n) * 4
    nbytes = 2 * H * W * elem + out
    ops_rate = (row["int32_lanes_per_sm"] * row["sms"]
                * row["max_sm_clock_mhz"] * 1e6 * (4 if elem == 1 else 1))
    return max(nbytes / row["hbm_bytes_per_s"], D * D * H * W / ops_rate)


class Recorder:
    def __init__(self, module, seed: int, fault: str = None):
        self.mod = module
        self.seed = seed
        self.fault = fault
        self.launches = []       # dicts: entry, H, W, R, n, base, elem, t_ns
        self.keep = False
        self.in_window = 0       # launches made while `keep` was on
        self.faulted = None      # the kept launch that carries the fault
        self.wrapper_s = 0.0
        self._sample = []        # the reservoir
        self._rng = random.Random(seed)
        self._orig = {}

    def install(self):
        for name in ENTRIES:
            orig = getattr(self.mod, name)
            wrapper = self._wrap(name, orig)
            # the entry points count their launches on their own function
            # object, looked up by name: the wrapper carries the counters
            wrapper.__dict__.update(orig.__dict__)
            self._orig[name] = orig
            setattr(self.mod, name, wrapper)

    def uninstall(self):
        for name, orig in self._orig.items():
            orig.__dict__.update(getattr(self.mod, name).__dict__)
            setattr(self.mod, name, orig)
        self._orig.clear()

    def kept(self):
        """The kept launches: the faulted one, then the sample."""
        return ([self.faulted] if self.faulted else []) + self._sample

    def _wrap(self, name, orig):
        def wrapper(ref, src, srange, *args, **kw):
            out = orig(ref, src, srange, *args, **kw)
            t0 = time.perf_counter()
            H, W = src.shape
            rec = dict(entry=name, H=H, W=W, R=srange,
                       elem=src.element_size(), t_ns=time.time_ns(),
                       n=args[0] if name == "sad_sweep_best" else None,
                       base=4 if name == "sad_block4_sweep" else 8)
            if name == "sad_sweep_best":
                rec["lam"] = args[1]
            self.launches.append(rec)
            if self.keep:
                out = self._keep(rec, ref, src, out)
            self.wrapper_s += time.perf_counter() - t0
            return out
        return wrapper

    def _keep(self, rec, ref, src, out):
        """Algorithm R over the window's launches; a launch the test fault
        is planted in is kept apart."""
        self.in_window += 1
        if rec["entry"] == "sad_sweep_best" and self.faulted is None \
                and self.fault in ("k1_answer", "half_blocks"):
            out = self._plant(out)
            self.faulted = self._copy(rec, ref, src, out)
            return out
        j = self._rng.randrange(self.in_window) \
            if len(self._sample) >= KEPT else len(self._sample)
        if j < KEPT:
            k = self._copy(rec, ref, src, out)
            if j < len(self._sample):
                self._sample[j] = k
            else:
                self._sample.append(k)
        return out

    def _plant(self, out):
        """One block's MV moved by a pixel, or the second half of the
        blocks left unsearched (MV and SAD 0)."""
        mvx, mvy, sad = (t.clone() for t in out)
        if self.fault == "k1_answer":
            mvx[0] += 1
        else:
            half = mvx.numel() // 2
            for t in (mvx, mvy, sad):
                t[half:] = 0
        return mvx, mvy, sad

    def _copy(self, rec, ref, src, out):
        """Copies on the device, queued behind the launch: the program may
        write into its buffers later."""
        k = dict(rec, ref=ref.clone(), src=src.clone())
        if rec["entry"] == "sad_sweep_best":
            k["answer"] = tuple(t.clone() for t in out)
            return k
        # a surface: each displacement's sum over all blocks, and entries
        # at places drawn from the seed
        gen = torch.Generator(device=out.device)
        gen.manual_seed(self.seed + self.in_window)
        flat = out.reshape(-1)
        idx = torch.randint(0, flat.numel(), (SURFACE_SAMPLES,),
                            generator=gen, device=out.device)
        k["sums"] = out.sum(dim=(2, 3), dtype=torch.int64)
        k["idx"], k["samples"] = idx, flat[idx]
        return k


def check(kept, device) -> int:
    """Answers of the kept launches that differ from the plain search:
    blocks whose (mvx, mvy, sad) differ for a fused sweep; displacement
    sums and sampled entries that differ for a surface."""
    bad = 0
    for k in kept:
        ref, src = k["ref"].to(device), k["src"].to(device)
        surf = reference.sad_surface(ref, src, k["R"], k["base"])
        if k["entry"] == "sad_sweep_best":
            want = reference.best_moves(surf, k["n"], k["R"], k["lam"])
            diff = torch.zeros_like(want[0], dtype=torch.bool)
            for a, b in zip(k["answer"], want):
                diff |= a.to(device).to(torch.int64) != b.to(torch.int64)
            bad += int(diff.sum())
        else:
            sums = surf.sum(dim=(2, 3), dtype=torch.int64)
            bad += int((sums != k["sums"].to(device)).sum())
            got = surf.reshape(-1)[k["idx"].to(device)]
            bad += int((got.to(torch.int64)
                        != k["samples"].to(device).to(torch.int64)).sum())
    return bad
