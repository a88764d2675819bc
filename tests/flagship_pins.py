"""The flagship session's test clip and the JAX package's pins over it,
shared by tests/test_torch_badapt.py, tests/test_torch_hme.py and
chip_smoke.py (this module imports neither JAX nor the JAX package).

CLIP, 160x96, 12 frames: a slow pan, a new scene panning 6 pixels a
frame from frame 3 (the P anchors of full mini-GOPs then sit 24 pixels
away, past the +-16 fine search: HME's range), and a brightness inversion
from frame 9 (the histogram cut). The sessions are bench.py's constructor
(x265_yuuki_asuna_tpu_torch.profile_1080p.FLAGSHIP) with SESSIONS' keywords
over it; PINS holds the md5 of the JAX package's stream of each and each
frame's (POC, type, QP) in coding order."""
import contextlib
from unittest import mock

import numpy as np

W, H = 160, 96
N_FRAMES = 12
SESSIONS = {"flagship": {}, "b_adapt1": {"b_adapt": 1},
            "hist_scenecut": {"hist_scenecut": True, "keyint": 20},
            "rc_lookahead3": {"rc_lookahead": 3}}
PINS = {
    "flagship": (
        "f9f6a72a1063b739f488ee0eb6f0b49b",
        [(0, "I", 25), (2, "P", 35), (1, "b", 36), (6, "P", 31),
         (4, "B", 36), (3, "b", 36), (5, "b", 35), (8, "P", 32),
         (7, "b", 34), (11, "P", 30), (10, "B", 35), (9, "b", 35)]),
    "b_adapt1": (
        "eb3524c20ea4bbb0cd109da3158f6cc3",
        [(0, "I", 25), (3, "P", 35), (2, "B", 38), (1, "b", 37),
         (7, "P", 33), (5, "B", 35), (4, "b", 35), (6, "b", 34),
         (9, "P", 31), (8, "b", 36), (11, "P", 33), (10, "b", 35)]),
    "hist_scenecut": (
        "b891316b437d625740c9cc527a0e9a5e",
        [(0, "I", 25), (2, "P", 35), (1, "b", 36), (6, "P", 31),
         (4, "B", 36), (3, "b", 36), (5, "b", 35), (8, "P", 32),
         (7, "b", 34), (0, "I", 27), (2, "P", 34), (1, "b", 35)]),
    "rc_lookahead3": (
        "a990087ac7e32523a46dde8caf91f0fe",
        [(0, "I", 25), (2, "P", 35), (1, "b", 37), (6, "P", 32),
         (4, "B", 37), (3, "b", 37), (5, "b", 36), (8, "P", 33),
         (7, "b", 34), (11, "P", 31), (10, "B", 35), (9, "b", 35)])}


def smooth_texture(rng, h: int, w: int) -> np.ndarray:
    """Random values on a 4x4 grid, blurred: texture ME can follow."""
    t = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2)).astype(np.float64)
    t = np.kron(t, np.ones((4, 4)))[:h, :w]
    for ax in (0, 1):
        t = (np.roll(t, 1, ax) + t + np.roll(t, -1, ax)) / 3
    return t


def clip(n: int = N_FRAMES, w: int = W, h: int = H, seed: int = 5):
    """Frames 0-2: scene A panning 3 pixels a frame; from frame 3: scene B
    panning 6 pixels a frame and a row down; from frame 9: scene B with
    its brightness inverted."""
    rng = np.random.default_rng(seed)
    ta = smooth_texture(rng, h + 64, w + 400)
    tb = smooth_texture(rng, h + 64, w + 400)
    grad = np.add.outer(np.arange(h), np.arange(w)) * 0.3
    frames = []
    for i in range(n):
        if i < 3:
            y = ta[8:8 + h, 40 + 3 * i:40 + 3 * i + w] * 0.8 + grad
        else:
            x = 6 * (i - 3)
            y = tb[8 + i:8 + i + h, x:x + w] * 0.8 + grad
        if i >= 9:
            y = 255 - y * 0.7
        frames.append((np.clip(y, 0, 255).astype(np.uint8),
                       np.full((h // 2, w // 2), 100 + i, np.uint8),
                       np.full((h // 2, w // 2), 140 - i, np.uint8)))
    return frames


@contextlib.contextmanager
def coarse_mvs_counted():
    """While open, count the blocks HME scored ("blocks") and those whose
    integer winner became HME's doubled coarse MV ("taken", a device
    tensor once a block was scored) in the port's quadtree programs."""
    from x265_yuuki_asuna_tpu_torch.models import inter_encoder
    count = {"taken": 0, "blocks": 0}
    choose = inter_encoder.hme_takes_coarse

    def counted(*args):
        use = choose(*args)
        count["taken"] = count["taken"] + use.sum()
        count["blocks"] += use.numel()
        return use
    with mock.patch.object(inter_encoder, "hme_takes_coarse", counted):
        yield count
