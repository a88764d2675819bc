"""The port's B-frame session (CPU): the CTU32 depth-2 quadtree with
bframes=3, the B-pyramid and fixed mini-GOPs (b_adapt=0) through
push_frame / flush, on the golden clip at 64x48, 8 frames, keyint 5. That
codes a pyramid mini-GOP (P 4, referenced B 2, b 1, b 3), an IDR in
mid-stream and a one-B flat mini-GOP at flush (P 2, b 1);
test_torch_qt_session.py compares it with the JAX session NAL for NAL and
with the JAX md5 pinned here. A flat bframes=2 session is held to its
pinned JAX md5, and a hash-SEI session checks the recon it returns. The
card tests (gpu-marked) hold the golden B stream on the card and a B
frame's kernel path against its plain path."""
import hashlib
from unittest import mock

import numpy as np
import pytest
import torch

from golden_corpus import clip
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad

torch.set_num_threads(2)

B_KW = dict(qp=30, max_depth=2, keyint=5, hash_sei=False, bframes=3,
            b_pyramid=True, b_adapt=0)
FLAT_KW = dict(B_KW, bframes=2, b_pyramid=False)
# md5 of the JAX package's stream of each session on clip(64, 48, n=8)
MD5 = {"pyramid": "0eca13bc30dfb501333206d7751facc6",
       "flat": "642ca26b4dd195c604b060915a14a67b"}
# (poc, frame type) of the results, in coding order
ORDER = {"pyramid": [(0, "I"), (4, "P"), (2, "B"), (1, "b"), (3, "b"),
                     (0, "I"), (2, "P"), (1, "b")],
         "flat": [(0, "I"), (3, "P"), (1, "b"), (2, "b"), (4, "P"),
                  (0, "I"), (2, "P"), (1, "b")]}


def encode_push(top, kw, setup=None, **extra):
    """(headers, results) of a push/flush session of the encoder_top
    module `top` over the golden clip; setup(session) runs first."""
    s = top.VideoEncoderSession(64, 48, **kw, **extra)
    if setup is not None:
        setup(s)
    res = []
    for f in clip(64, 48, n=8):
        res += s.push_frame(*f)
    res += s.flush()
    return s.headers(), res


def _md5(hdr, res):
    return hashlib.md5(hdr + b"".join(r.nals for r in res)).hexdigest()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


def test_qt2_flat_b_stream_matches_pinned_jax_md5():
    hdr, res = encode_push(t_top, FLAT_KW, device="cpu")
    assert [(r.poc, r.frame_type) for r in res] == ORDER["flat"]
    assert _md5(hdr, res) == MD5["flat"]


def test_qt2_b_session_recon_and_hash_sei():
    """With the hash SEI on, each B result's recon is the one its SEI
    hashes, and the anchors stay on the device."""
    s = t_top.VideoEncoderSession(64, 64, **dict(B_KW, hash_sei=True),
                                  device="cpu")
    res = []
    for f in clip(64, 64, n=5):
        res += s.push_frame(*f)
    assert [r.frame_type for r in res] == ["I", "P", "B", "b", "b"]
    for r in res:
        md5 = hashlib.md5(r.recon[0].tobytes()).digest()
        assert md5 in r.nals and np.isfinite(r.psnr_y)
    assert isinstance(s.anchor[0][0], torch.Tensor) and s.anchor[1] == 4
    assert s.flush() == []


@pytest.mark.gpu
def test_qt2_b_golden_on_the_card():
    _need_card()
    assert _md5(*encode_push(t_top, B_KW)) == MD5["pyramid"]


@pytest.mark.gpu
def test_qt2_b_frame_kernel_vs_plain_on_the_card():
    _need_card()
    s = t_top.VideoEncoderSession(128, 96, **B_KW)
    enc = s.inter_encoder
    calls, run = [], enc.encode_frame
    enc.encode_frame = lambda *a, **k: calls.append((a, k)) or run(*a, **k)
    for f in clip(128, 96, n=5):
        s.push_frame(*f)
    a, k = calls[-1]                   # the last b frame (POC 3)
    assert k["ref1"] is not None
    before = me_sad.sad_block8_sweep.launches
    out_k = run(*a, **k)
    assert me_sad.sad_block8_sweep.launches == before + 2    # L0 and L1
    with mock.patch.object(me_sad, "sad_block8_sweep",
                           me_sad.sad_block8_sweep_plain):
        out_p = run(*a, **k)
    for key, v in out_k.items():
        if key == "recon_dev":
            assert all(torch.equal(x, z) for x, z in zip(v, out_p[key]))
        elif v is None:
            assert out_p[key] is None
        else:
            assert np.array_equal(v, out_p[key]), key
