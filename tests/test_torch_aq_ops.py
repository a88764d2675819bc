"""Adaptive quantization and cuTree in the port against the JAX package
(CPU, exact, no program compile): AQ's per-CU offsets (modes 1-4), the
cuTree propagation over a lookahead window and its causal average in the
video session, the decoder-side QP of a per-CU map (the host form and the
device chain's), the uniform deblock's per-CU branches, the writers'
cu_qp_delta and the PPS that enables it."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_qt_ops import _random_sao, _random_tree
from x265_yuuki_asuna_tpu.bitstream import headers as j_hdr
from x265_yuuki_asuna_tpu.bitstream import native as j_native
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.models import ratecontrol as j_rc
from x265_yuuki_asuna_tpu.models import slicetype as j_st
from x265_yuuki_asuna_tpu.ops import deblock as j_db
from x265_yuuki_asuna_tpu.ops import filters_dev as j_fd
from x265_yuuki_asuna_tpu_torch.bitstream import headers as t_hdr
from x265_yuuki_asuna_tpu_torch.bitstream import native as t_native
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import ratecontrol as t_rc
from x265_yuuki_asuna_tpu_torch.models import slicetype as t_st
from x265_yuuki_asuna_tpu_torch.ops import deblock as t_db
from x265_yuuki_asuna_tpu_torch.ops import filters as t_fl

torch.set_num_threads(2)


def _planes(seed, h=96, w=64):
    """A luma plane mixing a gradient, noise of varying strength and
    diagonal stripes (edges at every angle class), and two chroma planes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    amp = rng.integers(0, 60, (h // 16, w // 16)).repeat(16, 0).repeat(16, 1)
    stripes = 80 * (((xx + yy) // 6 + (xx - yy) // 9 * (yy > h // 2)) % 2)
    y = (xx * 2 + yy + rng.integers(-1, 2, (h, w)) * amp + stripes * (
        xx > w // 3))
    c = lambda: np.clip(rng.integers(90, 170, (h // 2, w // 2))
                        + (xx[::2, ::2] % 7) * 5, 0, 255)
    return (np.clip(y, 0, 255).astype(np.uint8), c().astype(np.uint8),
            c().astype(np.uint8))


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
@pytest.mark.parametrize("strength", [1.0, 0.6])
@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("cu", [16, 32])
def test_aq_offsets_match_jax(mode, strength, chroma, cu):
    y, u, v = _planes(mode * 10 + cu)
    kw = dict(u_plane=u, v_plane=v) if chroma else {}
    j = j_rc.compute_aq_offsets(y, cu, strength, mode=mode, **kw)
    t = t_rc.compute_aq_offsets(y, cu, strength, mode=mode, **kw)
    assert t.dtype == np.int32 and np.array_equal(j, t)
    if cu == 16:
        assert len(np.unique(t)) > 1          # the map is not flat


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_aq_offsets_of_a_flat_plane_are_uniform(mode):
    """A flat plane has one offset everywhere (not 0: the auto-variance
    modes centre on mean - 0.5 * (mean_sq - 11) / mean, and mode 1's log2
    of a zero energy sits far below its pivot)."""
    y = np.full((64, 64), 77, np.uint8)
    j = j_rc.compute_aq_offsets(y, 16, 1.0, mode=mode)
    t = t_rc.compute_aq_offsets(y, 16, 1.0, mode=mode)
    assert np.array_equal(j, t) and len(np.unique(t)) == 1


def _detail(rng, nby=6, nbx=4, has_prev=True, scenecut=False):
    """A lookahead detail dict as Lookahead.push leaves it (float32 costs,
    int32 lowres MVs reaching past the picture edges)."""
    icost = rng.integers(0, 4000, nby * nbx).astype(np.float32)
    return {"icost": icost,
            "sad": (icost * rng.random(nby * nbx) * 1.3).astype(np.float32),
            "mvx": rng.integers(-20, 21, nby * nbx).astype(np.int32),
            "mvy": rng.integers(-20, 21, nby * nbx).astype(np.int32),
            "has_prev": has_prev, "nb_x": nbx, "nb_y": nby,
            "scenecut": scenecut}


@pytest.mark.parametrize("case", ["one", "two", "three", "four",
                                  "scenecut", "no_prev"])
def test_cutree_window_matches_jax(case):
    rng = np.random.default_rng(len(case) * 7)
    n = {"one": 1, "two": 2, "three": 3}.get(case, 4)
    win = [_detail(rng) for _ in range(n)]
    if case == "scenecut":
        win[2]["scenecut"] = True
    if case == "no_prev":
        win[1]["has_prev"] = False
    for strength in (2.0, 1.5):
        j = j_st.cutree_propagate(win, strength=strength)
        t = t_st.cutree_propagate(win, strength=strength)
        assert np.array_equal(j, t)
    for cu, rows, cols in ((16, 6, 4), (32, 3, 2), (16, 7, 5)):
        assert np.array_equal(j_st.pool_to_cu(j, cu, rows, cols),
                              t_st.pool_to_cu(t, cu, rows, cols))
    if n > 1 and case != "no_prev":
        assert (t < 0).any()


@pytest.mark.parametrize("cu_size,max_depth", [(16, 0), (32, 2)])
def test_cutree_causal_average_matches_jax_session(cu_size, max_depth):
    """_cutree_update / _cutree_offsets of the two video sessions fed the
    same lookahead details, frame after frame (a frame without a previous
    one halves the average)."""
    kw = dict(cu_size=cu_size, max_depth=max_depth, cutree=True)
    j = j_top.VideoEncoderSession(64, 96, **kw)
    t = t_top.VideoEncoderSession(64, 96, device="cpu", **kw)
    rng = np.random.default_rng(cu_size)
    for i in range(6):
        d = _detail(rng, has_prev=i != 3)
        j.lookahead.last_detail = d
        t.lookahead.last_detail = d
        j._cutree_update()
        t._cutree_update()
        assert np.array_equal(j.cutree_acc, t.cutree_acc)
        assert np.array_equal(j.cutree_icost, t.cutree_icost)
        assert np.array_equal(j._cutree_offsets(), t._cutree_offsets())
    assert (t._cutree_offsets() < 0).any()


def _levels(rng, rows, cols, n, density):
    m = rng.random((rows, cols, 1, 1)) < density
    return (rng.integers(-2, 3, (rows, cols, n, n)) * m).astype(np.int32)


@pytest.mark.parametrize("n", [16, 32])
def test_effective_qp_map_matches_jax(n):
    rng = np.random.default_rng(n)
    rows, cols = 5, 7
    out = {"levels_y": _levels(rng, rows, cols, n, 0.4),
           "levels_cb": _levels(rng, rows, cols, n // 2, 0.2),
           "levels_cr": _levels(rng, rows, cols, n // 2, 0.2)}
    qmap = rng.integers(24, 40, (rows, cols)).astype(np.int32)
    for slice_qp in (30, 35):
        j = j_top.effective_qp_map(out, qmap, slice_qp)
        t = t_top.effective_qp_map(out, qmap, slice_qp)
        assert np.array_equal(j, t) and not np.array_equal(t, qmap)
    assert t_top.effective_qp_map(out, None, 30) is None


def test_effective_qp_of_the_chain_matches_both_jax_forms():
    """The device chain's decoder-side QP (filters.effective_qp) equals the
    JAX chain's (effective_qp_dev) and the host form's (effective_qp_map)
    on the same per-CTU map and levels."""
    rng = np.random.default_rng(5)
    rows, cols = 4, 6
    out = {"levels_y": _levels(rng, rows, cols, 32, 0.5),
           "levels_cb": _levels(rng, rows, cols, 16, 0.2),
           "levels_cr": _levels(rng, rows, cols, 16, 0.2)}
    cbf = np.concatenate([out[k].reshape(rows * cols, -1) for k in (
        "levels_y", "levels_cb", "levels_cr")], 1).any(1)
    for seed in range(4):
        qmap = np.random.default_rng(seed).integers(
            20, 45, (rows, cols)).astype(np.int32)
        t = t_fl.effective_qp(torch.as_tensor(qmap.reshape(-1)),
                              torch.as_tensor(cbf), 31).numpy()
        j = np.asarray(j_fd.effective_qp_dev(jnp.asarray(qmap.reshape(-1)),
                                             jnp.asarray(cbf), 31))
        h = j_top.effective_qp_map(out, qmap, 31).reshape(-1)
        assert np.array_equal(t, j) and np.array_equal(t, h)


def test_edge_qps_match_jax():
    q = np.random.default_rng(2).integers(0, 52, (6, 9)).astype(np.int32)
    j = j_db._edge_qps(q, 0, 0, 0)
    t = t_db.edge_qps(q, "cpu")
    for k in ("qv", "qh", "beta_v", "beta_h", "tc_c_v", "tc_c_h"):
        assert np.array_equal(np.asarray(j[k]), t[k].numpy()), k


def _recon(rng, h, w):
    """Blocky planes with steps across the 16-grid edges (the filters
    decide every way)."""
    blk = rng.integers(60, 200, (h // 8, w // 8)).repeat(8, 0).repeat(8, 1)
    y = np.clip(blk + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.int32)
    cb = lambda: np.clip(blk[::2, ::2] + rng.integers(-2, 3, (h // 2,
                                                              w // 2)),
                         0, 255).astype(np.int32)
    return y, cb(), cb()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uniform_deblock_with_a_qp_map_matches_jax(seed):
    rng = np.random.default_rng(seed)
    y, u, v = _recon(rng, 64, 96)
    qmap = rng.integers(22, 46, (4, 6)).astype(np.int32)
    t = lambda a: torch.as_tensor(a)
    j = j_db.deblock_frame_uniform(y, u, v, 16, qmap, 30)
    p = t_db.deblock_frame_uniform(t(y), t(u), t(v), 16, qmap, 30)
    for a, b in zip(j, p):
        assert np.array_equal(np.asarray(a), b.numpy())
    bs_v = rng.integers(0, 3, (4, 5)).astype(np.int32)
    bs_h = rng.integers(0, 3, (3, 6)).astype(np.int32)
    j = j_db.deblock_frame_inter(y, u, v, 16, qmap, 30, bs_v, bs_h)
    p = t_db.deblock_frame_inter(t(y), t(u), t(v), 16, qmap, 30, t(bs_v),
                                 t(bs_h))
    for a, b in zip(j, p):
        assert np.array_equal(np.asarray(a), b.numpy())
    # the map changes the filtering (the scalar call at its mean differs)
    flat = t_db.deblock_frame_inter(t(y), t(u), t(v), 16, 34, 33, t(bs_v),
                                    t(bs_h))
    assert not all(torch.equal(a, b) for a, b in zip(flat, p))


def _qp_map(rng, rows, cols):
    return rng.integers(24, 40, (rows, cols)).astype(np.int32)


@pytest.mark.parametrize("slice_type", [2, 1, 0])
def test_native_qt2_writer_with_qp_map_matches_jax(slice_type):
    rng = np.random.default_rng(60 + slice_type)
    out = _random_tree(rng, 3, 4, slice_type)
    # some CTUs without residual: their delta waits for the next coded one
    for k, n in (("levels_y", 32), ("levels_cb", 16), ("levels_cr", 16)):
        out[k][0, 1] = 0
        out[k][2, 2] = 0
    qmap = _qp_map(rng, 3, 4)
    kw = dict(poc=2, poc_l0=0, poc_l1=4) if slice_type == 0 else {}
    for sao in (None, _random_sao(rng, 3, 4)):
        j = j_native.encode_slice_qt2(slice_type, 2, out, 30, 3, sao=sao,
                                      qp_map=qmap, **kw)
        t = t_native.encode_slice_qt2(slice_type, 2, out, 30, 3, sao=sao,
                                      qp_map=qmap, **kw)
        assert j is not None and t == j
    assert t != t_native.encode_slice_qt2(slice_type, 2, out, 30, 3,
                                          sao=sao, **kw)


@pytest.mark.parametrize("slice_type", [2, 1])
def test_native_uniform_writers_with_qp_map_match_jax(slice_type):
    rng = np.random.default_rng(70 + slice_type)
    rows, cols = 3, 4
    ly, lcb, lcr = (_levels(rng, rows, cols, n, d) for n, d in (
        (16, 0.7), (8, 0.3), (8, 0.3)))
    modes = rng.integers(0, 35, (rows, cols)).astype(np.int32)
    qmap = _qp_map(rng, rows, cols)
    if slice_type == 2:
        args = (modes, ly, lcb, lcr, 4, 32)
        j = j_native.encode_intra_slice(*args, qp_map=qmap)
        t = t_native.encode_intra_slice(*args, qp_map=qmap)
        plain = t_native.encode_intra_slice(*args)
    else:
        mv = lambda: rng.choice([-8, -4, 0, 4, 8], (rows, cols)) \
            .astype(np.int32)
        args = (rng.random((rows, cols)) < 0.2, modes, mv(), mv(), ly, lcb,
                lcr, 4, 32, 3)
        j = j_native.encode_p_slice(*args, qp_map=qmap)
        t = t_native.encode_p_slice(*args, qp_map=qmap)
        plain = t_native.encode_p_slice(*args)
    assert j is not None and t == j and t != plain


def test_native_writer_checks_the_qp_map_size():
    out = _random_tree(np.random.default_rng(1), 3, 4, 2)
    with pytest.raises(ValueError, match="qp_map"):
        t_native.encode_slice_qt2(2, 2, out, 30, 3,
                                  qp_map=np.zeros((2, 4), np.int32))


def test_pps_with_cu_qp_delta_matches_jax():
    for kw in (dict(cu_qp_delta=1), dict(cu_qp_delta=1, sign_hiding=1,
                                         deblocking_disabled=1)):
        assert t_hdr.write_pps(t_hdr.PPSInfo(**kw)) == \
            j_hdr.write_pps(j_hdr.PPSInfo(**kw))
    assert t_hdr.write_pps(t_hdr.PPSInfo(cu_qp_delta=1)) != \
        t_hdr.write_pps(t_hdr.PPSInfo())
