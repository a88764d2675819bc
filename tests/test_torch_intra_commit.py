"""The quadtree intra commit (models/qt_common.py commit_intra): the
per-CTU leaf table against the plain list of leaves, the dispatch
between the CUDA kernel (ops/kernels/intra_commit.py) and the batched
commit, the kernel's constant tables against the Python ones, and, on
the card (`-m gpu`), the kernel against the batched commit bit for bit
on rec and levels."""
import os
import re
import zlib

import numpy as np
import pytest
import torch

from x265_yuuki_asuna_tpu_torch.bitstream import tables as TB
from x265_yuuki_asuna_tpu_torch.models import qt_common as QT
from x265_yuuki_asuna_tpu_torch.ops import intra, quant, transforms
from x265_yuuki_asuna_tpu_torch.ops.kernels import intra_commit as IC
from x265_yuuki_asuna_tpu_torch.ops.quant import PLAIN, Quantizer

CU_SRC = os.path.join(os.path.dirname(QT.__file__), "..", "csrc",
                      "intra_commit.cu")


def _decisions(rng, ncu: int, depth: int, flags: bool):
    """Random quadtree decisions of ncu CTUs as intra_leaves' arguments
    (flags: random per-leaf intra flags, else every leaf intra)."""
    m = lambda *shape: rng.integers(0, 35, shape)
    f = (lambda *shape: rng.random(shape) < 0.4) if flags else \
        (lambda *shape: None)
    d2 = depth == 2
    return (rng.random(ncu) < 0.7, rng.random((ncu, 4)) < 0.5 if d2 else None,
            m(ncu), m(ncu, 4), m(ncu, 4, 4) if d2 else None, f(ncu),
            f(ncu, 4), f(ncu, 4, 4) if d2 else None)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("flags", [False, True])
def test_leaf_table_decodes_to_intra_leaves(depth, flags):
    rng = np.random.default_rng(10 * depth + flags)
    dec = _decisions(rng, 60, depth, flags)
    table = QT.leaf_table(*dec)
    assert table.shape == (60, len(QT.ZPOS)) and table.dtype == np.int32
    ctu, k = np.nonzero(table >= 0)
    got = [(int(i), int(j), int(table[i, j])) for i, j in zip(ctu, k)]
    assert got == QT.intra_leaves(*dec) and got


class _Plane:
    """A stand-in for a CUDA plane: what the dispatch rule reads."""
    is_cuda = True

    def __init__(self, h, w):
        self.shape = (h, w)


@pytest.mark.parametrize("case,kernel", [
    ("plain", True), ("sbh_10bit", True), ("12bit", True), ("cpu", False),
    ("rdoq", False), ("scaling", False), ("i444", False), ("14bit", False)])
def test_dispatch_rule(case, kernel):
    """IC.takes: the kernel commits on the card for the plain and
    sign-hiding quantizers at 8-12 bits in 4:2:0; RDOQ, scaling lists,
    4:4:4 and CPU planes keep the batched commit."""
    q = {"plain": PLAIN, "sbh_10bit": Quantizer(sbh=True, bit_depth=10),
         "12bit": Quantizer(bit_depth=12), "cpu": PLAIN,
         "rdoq": Quantizer(rdoq=True), "scaling": Quantizer(scaling=object()),
         "i444": PLAIN, "14bit": Quantizer(bit_depth=14)}[case]
    planes = [_Plane(64, 96), _Plane(32, 48), _Plane(32, 48)]
    if case == "i444":
        planes[1:] = [_Plane(64, 96)] * 2
    if case == "cpu":
        planes = [torch.zeros(64, 96), torch.zeros(32, 48)]
    assert IC.takes(planes, q) is kernel


@pytest.mark.parametrize("case", ["cpu", "rdoq"])
def test_kernel_wrapper_refuses_what_it_does_not_take(case):
    """The wrapper only launches: CPU planes or a quantizer outside
    IC.takes raise before anything runs (commit_intra dispatches)."""
    geo = QT.QtGeometry(1, 2, torch.device("cpu"))
    table = np.full((geo.ncu, IC.NZ), -1, np.int32)
    table[:, 0] = 1
    if case == "cpu":
        planes, q = [torch.zeros(geo.H // s, geo.W // s, dtype=torch.int32)
                     for s in (1, 2, 2)], PLAIN
    else:
        planes = [_Plane(geo.H // s, geo.W // s) for s in (1, 2, 2)]
        q = Quantizer(rdoq=True)
    before = IC.intra_commit.launches, IC.intra_commit.leaves
    with pytest.raises(ValueError, match="takes CUDA 4:2:0 planes"):
        IC.intra_commit(table, geo, planes, planes, planes, None, True, q)
    assert (IC.intra_commit.launches, IC.intra_commit.leaves) == before


def test_cpu_planes_take_the_batched_commit():
    """On the CPU commit_intra runs the batched commit (its leaf count
    rises, the kernel's does not) and reconstructs every leaf."""
    rng = np.random.default_rng(3)
    geo = QT.QtGeometry(2, 3, torch.device("cpu"))
    table = QT.leaf_table(*_decisions(rng, geo.ncu, 2, False))
    src = tuple(torch.as_tensor(rng.integers(0, 256, (geo.H // s,
                                                       geo.W // s)),
                                dtype=torch.int32) for s in (1, 2, 2))
    rec = tuple(torch.zeros_like(p) for p in src)
    lv = tuple(torch.zeros_like(p) for p in src)
    before = (QT.commit_intra.batched_leaves, IC.intra_commit.leaves,
              IC.intra_commit.launches)
    QT.commit_intra(table, geo, src, rec, lv, QT.FrameQp(geo, 30), True)
    assert QT.commit_intra.batched_leaves - before[0] == (table >= 0).sum()
    assert (IC.intra_commit.leaves, IC.intra_commit.launches) == before[1:]
    # every sample of an I frame is a leaf's: recon near the source
    assert all(int((s - r).abs().max()) < 64 for s, r in zip(src, rec))


def _cu_array(src: str, name: str) -> np.ndarray:
    body = re.search(r"__constant__ [\w ]+ " + name
                     + r"(\[\d+\])+ = \{(.*?)\};", src, re.S).group(2)
    return np.array([int(v) for v in re.findall(r"-?\d+", body)])


def test_kernel_constant_tables_match_the_python_ones():
    """The DCT matrix, the angles and inverse angles, the quant scales
    and the 4x4 scans written into the CUDA source are the Python
    ones."""
    src = open(CU_SRC).read()
    dct = _cu_array(src, "kDct").reshape(32, 32)
    for n in (4, 8, 16, 32):
        assert np.array_equal(dct[::32 // n, :n], transforms.dct_matrix(n))
    assert np.array_equal(_cu_array(src, "kAngle"), intra.ANGLES)
    assert list(_cu_array(src, "kInvAngle")) == [
        intra.INV_ANGLES.get(int(a), 0) for a in intra.ANGLES]
    assert tuple(_cu_array(src, "kQuantScale")) == quant.QUANT_SCALES
    assert tuple(_cu_array(src, "kInvQuantScale")) == \
        quant.INV_QUANT_SCALES
    assert np.array_equal(_cu_array(src, "kScan4").reshape(3, 16), np.stack(
        [TB.scan_order(s, 2) for s in (TB.SCAN_DIAG, TB.SCAN_HOR,
                                       TB.SCAN_VER)]))
    thresh = _cu_array(src, "kFilterThresh")
    for i, n in enumerate((8, 16, 32)):
        flags = intra.mode_filter_flags(n)
        assert all(flags[m] == (min(abs(m - 26), abs(m - 10)) > thresh[i])
                   for m in range(2, 35))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _frame(rng, w: int, h: int, kind: str, bd: int, dev):
    """(geo, table, src, rec, lv) of one frame: the source a gradient with
    noise (flat and busy regions), rec / lv zero for an I frame, else
    holding inter leaves (the source with noise, small levels)."""
    geo = QT.QtGeometry(h // QT.N, w // QT.N, dev)
    depth = 1 if kind == "I1" else 2
    table = QT.leaf_table(*_decisions(rng, geo.ncu, depth, kind == "PB"))
    peak = (1 << bd) - 1

    def plane(s):
        hh, ww = geo.H // s, geo.W // s
        yy, xx = np.mgrid[:hh, :ww]
        amp = np.where((yy // 16 + xx // 16) % 3 == 0, peak // 4, peak // 64)
        base = (yy * 3 + xx * 2) * (peak + 1) // 512
        return np.clip(base + rng.integers(-1, 2, (hh, ww)) * amp, 0, peak)

    t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    src = tuple(t(plane(s)) for s in (1, 2, 2))
    if kind == "PB":
        rec = tuple(torch.clamp(p + t(rng.integers(-9, 10, p.shape)), 0, peak)
                    for p in src)
        lv = tuple(t(rng.integers(-3, 4, p.shape)) for p in src)
    else:
        rec = tuple(torch.zeros_like(p) for p in src)
        lv = tuple(torch.zeros_like(p) for p in src)
    return geo, table, src, rec, lv


CARD_CASES = [(256, 160, kind, qn, qp, bd) for kind in ("I1", "I2", "PB")
              for qn in ("plain", "sbh") for qp in ("one", "map")
              for bd in (8, 10)] + [
    (1920, 1088, "I2", "sbh", "map", 8), (1920, 1088, "PB", "sbh", "one", 8),
    (1920, 1088, "PB", "plain", "map", 10),
    (1920, 1088, "I1", "plain", "one", 10)] + [
    # 12 bits: the widest int32 ranges of quant and dequant; 9 and 11
    (256, 160, "I2", "plain", "map", 12), (256, 160, "I2", "sbh", "one", 12),
    (256, 160, "PB", "plain", "one", 12), (256, 160, "PB", "sbh", "map", 12),
    (256, 160, "I1", "sbh", "map", 9), (256, 160, "PB", "plain", "map", 11),
    (1920, 1088, "PB", "sbh", "map", 12)]


@pytest.mark.gpu
@pytest.mark.parametrize("w,h,kind,qn,qp,bd", CARD_CASES)
def test_kernel_matches_the_batched_commit_on_the_card(w, h, kind, qn, qp,
                                                       bd):
    """The kernel's rec and levels equal the batched commit's bit for bit
    (I slices at depth 1 and 2, P / B frames with random intra flags over
    inter leaves; plain and sign-hiding levels, every mode; one QP and a
    per-CTU map; 8, 10 and 12 bits, and 9 and 11), with one launch per
    diagonal that holds an intra leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(zlib.crc32(f"{w}{kind}{qn}{qp}{bd}".encode()))
    geo, table, src, rec, lv = _frame(rng, w, h, kind, bd,
                                      torch.device("cuda"))
    q = Quantizer(sbh=qn == "sbh", bit_depth=bd)
    fq = QT.FrameQp(geo, 30 if qp == "one" else
                    rng.integers(22, 45, (geo.rows, geo.cols)))
    intra_slice = kind != "PB"
    want_rec, want_lv = [p.clone() for p in rec], [p.clone() for p in lv]
    QT.commit_batched(table, geo, src, want_rec, want_lv, fq, intra_slice,
                      q)
    before = IC.intra_commit.launches, IC.intra_commit.leaves
    IC.intra_commit(table, geo, src, rec, lv, fq, intra_slice, q)
    torch.cuda.synchronize()
    diags = {2 * (i // geo.cols) + i % geo.cols
             for i in np.flatnonzero((table >= 0).any(1))}
    assert IC.intra_commit.launches - before[0] == len(diags)
    assert IC.intra_commit.leaves - before[1] == (table >= 0).sum()
    for p in range(3):
        assert torch.equal(rec[p], want_rec[p]), ("rec", p)
        assert torch.equal(lv[p], want_lv[p]), ("lv", p)


@pytest.mark.gpu
def test_commit_intra_dispatch_on_the_card():
    """On the card commit_intra launches the kernel for the plain
    quantizer and keeps the batched commit under RDOQ, with the same
    leaves counted on each side."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(5)
    geo, table, src, rec, lv = _frame(rng, 256, 160, "I2", 8,
                                      torch.device("cuda"))
    fq = QT.FrameQp(geo, 32)
    n = int((table >= 0).sum())
    b0, k0 = QT.commit_intra.batched_leaves, IC.intra_commit.leaves
    QT.commit_intra(table, geo, src, rec, lv, fq, True, PLAIN)
    assert (QT.commit_intra.batched_leaves - b0,
            IC.intra_commit.leaves - k0) == (0, n)
    QT.commit_intra(table, geo, src, rec, lv, fq, True, Quantizer(rdoq=True),
                    None)
    assert (QT.commit_intra.batched_leaves - b0,
            IC.intra_commit.leaves - k0) == (n, n)
