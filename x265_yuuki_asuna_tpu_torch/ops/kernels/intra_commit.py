"""The quadtree intra commit: the wrapper of the CUDA kernel in
`csrc/intra_commit.cu`.

`intra_commit` reconstructs a frame's decided intra leaves in place, as
models/qt_common.py's batched commit does, with one kernel launch per
CTU wavefront diagonal that holds an intra leaf. It replaces no TPU
kernel: the reference commits with XLA, and the port's batched commit
runs ~45 small PyTorch ops per (diagonal, z-order position), a chain the
host cannot issue fast enough (up to 126 x 21 of them a 1080p frame).
What bounds the kernel is the chain of dependent diagonals, each as long
as its slowest CTU, not its bytes (the CUDA source's header comment).
It takes the plain and sign-hiding quantizers on 4:2:0 planes of 8 to 12
bits (`takes`); models/qt_common.commit_intra dispatches by that rule,
and its batched commit (commit_batched) is the kernel's plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils import build

NZ = 21         # z-order positions of a CTU32 tree (qt_common.ZPOS)
_fn = []


def _kernel():
    if not _fn:
        fn = build.load("intra_commit").asuna_intra_commit
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i] * 6 + [p, i, p]
        fn.restype = i
        _fn.append(fn)
    return _fn[0]


def takes(src, quant_fn) -> bool:
    """Whether the kernel commits for these (y, u, v) planes and this
    quantizer: CUDA planes, 4:2:0, 8 to 12 bits, no RDOQ and no scaling
    lists (RDOQ prices levels in the float32 order ops/fp32.py keeps)."""
    y, u = src[0], src[1]
    return (y.is_cuda and not quant_fn.rdoq and quant_fn.scaling is None
            and quant_fn.csp420 and 8 <= quant_fn.bit_depth <= 12
            and tuple(u.shape) == (y.shape[0] // 2, y.shape[1] // 2))


def diagonals(table: np.ndarray, cols: int) -> np.ndarray:
    """The wavefront diagonals 2r + c of the CTUs that hold an intra leaf
    in `table` ([ncu, NZ] modes, -1: none), ascending, int32."""
    ctu = np.flatnonzero((table >= 0).any(1))
    return np.unique(2 * (ctu // cols) + ctu % cols).astype(np.int32)


def launch(table: torch.Tensor, diags: np.ndarray, geo, src, rec, lv, fq,
           intra_slice: bool, quant_fn) -> None:
    """One kernel launch per diagonal of `diags` on the current stream:
    table the device leaf table, the rest as for intra_commit."""
    planes = [*src, *rec, *lv]
    if not all(p.dtype == torch.int32 and p.is_contiguous()
               and p.device == table.device
               for p in planes + [fq.cu, fq.c]):
        raise ValueError("the kernel takes contiguous int32 planes and QPs "
                         "on the table's device")
    if tuple(src[0].shape) != (geo.H, geo.W):
        raise ValueError(f"luma plane {tuple(src[0].shape)} for a "
                         f"{geo.H}x{geo.W} CTU grid")
    d = np.ascontiguousarray(diags, np.int32)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(table.data_ptr(), fq.cu.data_ptr(), fq.c.data_ptr(),
                        *(p.data_ptr() for p in planes), geo.W, geo.rows,
                        geo.cols, quant_fn.bit_depth, int(intra_slice),
                        int(quant_fn.sbh), d.ctypes.data, len(d), stream)
    if err:
        raise RuntimeError(f"intra commit launch failed: CUDA error {err}")
    intra_commit.launches += len(d)


def intra_commit(table: np.ndarray, geo, src, rec, lv, fq,
                 intra_slice: bool, quant_fn) -> None:
    """Reconstruct the intra leaves of `table` (host int32 [ncu, NZ]: the
    mode of the leaf at each CTU's z-order position, -1 where there is
    none) in place: src, rec, lv the (y, u, v) int32 planes of the
    frame's source, recon and levels on one device, geo its QtGeometry,
    fq its FrameQp, intra_slice the slice's quant rounding, quant_fn a
    quantizer the kernel takes (takes(); anything else raises). The
    table goes up once, through pinned memory. `intra_commit.launches`
    counts launches, `intra_commit.leaves` the leaves it committed."""
    if not takes(src, quant_fn):
        raise ValueError("the intra commit kernel takes CUDA 4:2:0 planes "
                         "of 8 to 12 bits and the plain or sign-hiding "
                         "quantizer")
    table = np.ascontiguousarray(table, np.int32)
    if table.shape != (geo.ncu, NZ):
        raise ValueError(f"leaf table {table.shape} for {geo.ncu} CTUs")
    diags = diagonals(table, geo.cols)
    if not len(diags):
        return
    dev = torch.from_numpy(table).pin_memory().to(src[0].device,
                                                  non_blocking=True)
    launch(dev, diags, geo, src, rec, lv, fq, intra_slice, quant_fn)
    intra_commit.leaves += int((table >= 0).sum())


intra_commit.launches = 0
intra_commit.leaves = 0
