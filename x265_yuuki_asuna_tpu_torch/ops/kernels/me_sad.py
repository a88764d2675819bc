"""K1, the motion-estimation SAD sweep: wrappers of the CUDA kernels in
`csrc/me_sad.cu` and their plain PyTorch versions.

Two entry points:
  * `sad_block8_sweep` — the surface of 8x8-block SADs of every
    displacement (replaces the TPU kernel
    x265_yuuki_asuna_tpu/ops/pallas/me_sad.py sad_block8_sweep);
  * `sad_sweep_best`   — the fused sweep and argmin: each n x n block's
    best (mvx, mvy, sad), as sad_sweep_multi_pallas computes it for one
    size, without writing the surface.
The kernels' design and bounds are in the CUDA source's header comment.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import build

_DTYPES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}
# largest |a - b| of two elements, for the fused kernel's key budget
_MAX_DIFF = {torch.uint8: 255, torch.int16: 65535, torch.int32: 2 ** 32 - 1}
BEST_SIZES = (8, 16)
_fns = {}


def _kernel(name: str):
    if not _fns:
        lib = build.load("me_sad")
        p, i = ctypes.c_void_p, ctypes.c_int
        fns = {"surface": lib.asuna_sad_block8_sweep,
               "best": lib.asuna_sad_sweep_best}
        fns["surface"].argtypes = [p] * 3 + [i] * 4 + [p]
        fns["best"].argtypes = [p] * 3 + [i] * 8 + [p]
        for fn in fns.values():
            fn.restype = i
        _fns.update(fns)
    return _fns[name]


def _check_planes(ref_plane: torch.Tensor, src_plane: torch.Tensor,
                  n: int = 8):
    if ref_plane.shape != src_plane.shape or src_plane.ndim != 2:
        raise ValueError("ref and src must be [H, W] planes of one shape")
    H, W = src_plane.shape
    if H % n or W % n:
        raise ValueError(f"plane {H}x{W}: H and W must be multiples of {n}")
    if ref_plane.dtype != src_plane.dtype or src_plane.dtype not in _DTYPES:
        raise TypeError(f"planes must share one of uint8/int16/int32, got "
                        f"{ref_plane.dtype} and {src_plane.dtype}")
    if ref_plane.device != src_plane.device:
        raise ValueError("ref and src lie on different devices")
    if src_plane.is_cuda and not all(
            p.is_contiguous() and p.data_ptr() % 16 == 0
            for p in (ref_plane, src_plane)):
        raise ValueError("the kernels take contiguous, 16-byte aligned "
                         "planes")


def _launch(name: str, plane: torch.Tensor, *args):
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(*args, stream)
    if err:
        raise RuntimeError(f"K1 {name} launch failed: CUDA error {err}")


def sad_block8_sweep_plain(ref_plane: torch.Tensor, src_plane: torch.Tensor,
                           srange: int) -> torch.Tensor:
    """Plain version: a loop over dy, vectorised over dx. The reference is
    edge-extended by clamping its row and column indices."""
    H, W = src_plane.shape
    R = srange
    D = 2 * R + 1
    dev = src_plane.device
    ref = ref_plane.to(torch.int32)
    src = src_plane.to(torch.int32)
    cols = (torch.arange(W, device=dev)[None, :]
            + torch.arange(D, device=dev)[:, None] - R).clamp(0, W - 1)
    ys = torch.arange(H, device=dev)
    out = torch.empty((D, D, H // 8, W // 8), dtype=torch.int32, device=dev)
    for dyi in range(D):
        rows = ref[(ys + dyi - R).clamp(0, H - 1)]            # [H, W]
        d = (rows[:, cols] - src[:, None, :]).abs()           # [H, D, W]
        out[dyi] = d.reshape(H // 8, 8, D, W // 8, 8).sum(dim=(1, 4)) \
            .permute(1, 0, 2)
    return out


def sad_block8_sweep(ref_plane: torch.Tensor, src_plane: torch.Tensor,
                     srange: int) -> torch.Tensor:
    """[D, D, H/8, W/8] int32: 8x8-block SADs for every (dy, dx) in
    [-R, R]^2 (edge-extended reference). ref_plane/src_plane: [H, W]
    uint8/int16/int32 planes of one dtype, H and W multiples of 8.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. `sad_block8_sweep.launches` counts kernel launches."""
    _check_planes(ref_plane, src_plane)
    if not src_plane.is_cuda:
        return sad_block8_sweep_plain(ref_plane, src_plane, srange)
    H, W = src_plane.shape
    D = 2 * srange + 1
    out = torch.empty((D, D, H // 8, W // 8), dtype=torch.int32,
                      device=src_plane.device)
    _launch("surface", src_plane, ref_plane.data_ptr(), src_plane.data_ptr(),
            out.data_ptr(), H, W, srange, _DTYPES[src_plane.dtype])
    sad_block8_sweep.launches += 1
    return out


sad_block8_sweep.launches = 0


def best_of_surface(s8: torch.Tensor, n: int, srange: int,
                    lambda_bits: int):
    """(mvx, mvy, sad) int32 [nblocks] of the n x n blocks (raster order)
    from the 8x8 surface: f x f sums (f = n/8), cost = SAD + lambda_bits *
    (|dx| + |dy|), first minimum in row-major (dy, dx) order (torch.argmin
    returns the first minimum)."""
    D, _, hb, wb = s8.shape
    R = srange
    f = n // 8
    s = s8 if f == 1 else \
        s8.reshape(D, D, hb // f, f, wb // f, f).sum(dim=(3, 5))
    d = (torch.arange(D, device=s8.device) - R).abs()
    bias = lambda_bits * (d[:, None] + d[None, :])           # [dy, dx]
    flat = s.reshape(D * D, -1)
    best = torch.argmin(flat + bias.reshape(D * D, 1), dim=0)
    sad = torch.gather(flat, 0, best[None])[0]
    return ((best % D - R).to(torch.int32), (best // D - R).to(torch.int32),
            sad.to(torch.int32))


def sad_sweep_best_plain(ref_plane: torch.Tensor, src_plane: torch.Tensor,
                         srange: int, n: int, lambda_bits: int):
    """Plain version: the plain surface, then best_of_surface."""
    return best_of_surface(sad_block8_sweep_plain(ref_plane, src_plane,
                                                  srange),
                           n, srange, lambda_bits)


def key_layout(dtype: torch.dtype, n: int, srange: int, lambda_bits: int):
    """(shift, key dtype) of the fused kernel's packed argmin key
    cost << shift | (dyi * D + dxi): shift holds the displacement index,
    and the key is int32 when the largest cost leaves it below 2^31, else
    int64 (the kernel reads both as unsigned). Block SADs are taken to fit
    in 31 bits, as the surface's int32 entries do."""
    D = 2 * srange + 1
    shift = max(1, (D * D - 1).bit_length())
    cost_max = min(n * n * _MAX_DIFF[dtype], 2 ** 31 - 1) \
        + lambda_bits * 2 * srange
    bits = cost_max.bit_length() + shift
    if bits <= 31:
        return shift, torch.int32
    if bits <= 63:
        return shift, torch.int64
    raise ValueError(f"the argmin key needs {bits} bits (R={srange}, "
                     f"lambda_bits={lambda_bits})")


def unpack_keys(keys: torch.Tensor, srange: int, shift: int,
                lambda_bits: int):
    """(mvx, mvy, sad) int32 of packed keys cost << shift | (dyi*D + dxi)."""
    D = 2 * srange + 1
    idx = keys & ((1 << shift) - 1)
    mv = torch.stack((idx % D, idx // D)) - srange            # [2, nb]
    sad = (keys >> shift) - lambda_bits * mv.abs().sum(dim=0)
    return mv[0].to(torch.int32), mv[1].to(torch.int32), sad.to(torch.int32)


def sad_sweep_best(ref_plane: torch.Tensor, src_plane: torch.Tensor,
                   srange: int, n: int, lambda_bits: int):
    """(mvx, mvy, sad) int32 [(H/n) * (W/n)] in raster block order: for
    each n x n block (n = 8 or 16) the displacement in [-R, R]^2 of least
    SAD + lambda_bits * (|dx| + |dy|), the first in row-major (dy, dx)
    order on ties; exactly sad_sweep_multi(ref, src, (n,), R,
    lambda_bits)[n]. Planes as for sad_block8_sweep, H and W multiples of n.

    CUDA tensors launch the fused kernel (or raise); CPU tensors take the
    plain version. `sad_sweep_best.launches` counts kernel launches."""
    if n not in BEST_SIZES:
        raise ValueError(f"block size {n}: the fused sweep takes 8 or 16")
    if lambda_bits < 0:
        raise ValueError("lambda_bits must be >= 0")
    _check_planes(ref_plane, src_plane, n)
    if not src_plane.is_cuda:
        return sad_sweep_best_plain(ref_plane, src_plane, srange, n,
                                    lambda_bits)
    H, W = src_plane.shape
    shift, kdt = key_layout(src_plane.dtype, n, srange, lambda_bits)
    keys = torch.full(((H // n) * (W // n),), -1, dtype=kdt,
                      device=src_plane.device)
    _launch("best", src_plane, ref_plane.data_ptr(), src_plane.data_ptr(),
            keys.data_ptr(), H, W, srange, n, lambda_bits, shift,
            keys.element_size(), _DTYPES[src_plane.dtype])
    sad_sweep_best.launches += 1
    return unpack_keys(keys, srange, shift, lambda_bits)


sad_sweep_best.launches = 0
