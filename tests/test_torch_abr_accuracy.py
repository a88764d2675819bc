"""One-pass ABR accuracy of the port on the card, the counterpart of
tests/test_abr_accuracy.py: a 100-frame 176x144 clip on the uniform
16x16 IPPP path lands within 1.2% of its target (the reference's
rate-control tests accept 1% drift). Slow (200 frames) and on the card:
python -m pytest -m "slow and gpu" tests/test_torch_abr_accuracy.py."""
import numpy as np
import pytest
import torch

from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
    VideoEncoderSession


def _clip(w: int, h: int, n: int):
    rng = np.random.default_rng(5)
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8)
    tex = rng.integers(0, 40, (h, w)).astype(np.uint8)
    for i in range(n):
        y = (base + np.roll(tex, (i, 2 * i), (0, 1)) + i).astype(np.uint8)
        yield (y, (base[::2, ::2] // 2 + i).astype(np.uint8),
               ((255 - base[::2, ::2]) // 2).astype(np.uint8))


@pytest.mark.slow
@pytest.mark.gpu
@pytest.mark.parametrize("target_kbps", [300, 800])
def test_abr_hits_target_100_frames_on_the_card(target_kbps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    W, H, N = 176, 144, 100
    s = VideoEncoderSession(W, H, cu_size=16, keyint=250, hash_sei=False,
                            rc_mode="abr", bitrate_kbps=target_kbps)
    tot = sum(s.encode_frame(*f).bits for f in _clip(W, H, N))
    kbps = tot * 25.0 / N / 1000.0
    err = kbps / target_kbps - 1.0
    print(f"ABR {target_kbps} kbps on {torch.cuda.get_device_name(0)}: "
          f"{kbps:.3f} kbps ({err:+.4%})")
    assert abs(err) <= 0.012, f"ABR {target_kbps}: {kbps:.1f} ({err:+.1%})"
