"""The plain reference that decides `correct`.

It imports nothing of the encoder under test and takes nothing it made
but the outputs being judged:

  * `decode_hevc`: an independent HEVC decoder (FFmpeg's libavcodec, as
    the opencv wheel ships it, through ctypes) turns the Annex-B stream
    the run produced into pictures;
  * `recon_mismatch`: those pictures against the encoder's own
    reconstruction, sample for sample (an encoder's stream must decode to
    the pictures it predicts from);
  * `psnr`: quality of the decoded pictures against the source;
  * `sad_surface` / `best_moves`: K1's motion search done plainly (the
    SAD of every block at every displacement in [-R, R]^2 on the
    edge-extended reference, cost SAD + lambda * (|dx| + |dy|), the first
    least cost in (dy, dx) row-major order), to recompute the answers the
    kernel returned.
"""

from __future__ import annotations

import ctypes
import glob
import math
import os
import re
from typing import List

import numpy as np
import torch

_AV = None
_AVFRAME_WIDTH = 8 * 8 + 8 * 4 + 8     # after data[8], linesize[8],
#                                       extended_data (FFmpeg 4 to 7)
_PIX_FMT_YUV420P = 0


def _load_av():
    """(avutil, avcodec): FFmpeg's libraries as the opencv wheel ships
    them. Importing cv2 first loads the libraries they depend on, which
    the wheel keeps beside them under hashed names."""
    global _AV
    if _AV is not None:
        return _AV
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"no decoder: the opencv wheel (its FFmpeg) is "
                           f"not installed ({e})") from e
    site = os.path.dirname(os.path.dirname(os.path.abspath(cv2.__file__)))
    found = {}
    for lib in ("avutil", "avcodec"):
        paths = sorted(glob.glob(os.path.join(site, "opencv_python*.libs",
                                              f"lib{lib}*.so*")))
        if not paths:
            raise RuntimeError(f"no decoder: lib{lib} is not in the opencv "
                               "wheel")
        found[lib] = ctypes.CDLL(paths[0], mode=ctypes.RTLD_GLOBAL)
    avutil, avcodec = found["avutil"], found["avcodec"]
    vp, ip = ctypes.c_void_p, ctypes.c_int
    pp = ctypes.POINTER(vp)
    avcodec.avcodec_find_decoder_by_name.restype = vp
    avcodec.avcodec_find_decoder_by_name.argtypes = [ctypes.c_char_p]
    avcodec.avcodec_alloc_context3.restype = vp
    avcodec.avcodec_alloc_context3.argtypes = [vp]
    avcodec.avcodec_open2.restype = ip
    avcodec.avcodec_open2.argtypes = [vp, vp, vp]
    avcodec.avcodec_free_context.argtypes = [pp]
    avcodec.av_packet_alloc.restype = vp
    avcodec.av_packet_free.argtypes = [pp]
    avcodec.av_packet_from_data.restype = ip
    avcodec.av_packet_from_data.argtypes = [vp, vp, ip]
    avcodec.avcodec_send_packet.restype = ip
    avcodec.avcodec_send_packet.argtypes = [vp, vp]
    avcodec.avcodec_receive_frame.restype = ip
    avcodec.avcodec_receive_frame.argtypes = [vp, vp]
    avutil.av_frame_alloc.restype = vp
    avutil.av_frame_free.argtypes = [pp]
    avutil.av_mallocz.restype = vp
    avutil.av_mallocz.argtypes = [ctypes.c_size_t]
    _AV = (avutil, avcodec)
    return _AV


def nal_units(stream: bytes) -> List[bytes]:
    """The NAL units of an Annex-B stream, start codes removed."""
    starts = [m.end() for m in re.finditer(b"\x00\x00\x01", stream)]
    out = []
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else len(stream)
        out.append(stream[s:e].rstrip(b"\x00") if k + 1 < len(starts)
                   else stream[s:e])
    return out


def access_units(stream: bytes) -> List[bytes]:
    """The stream cut into access units: a VCL NAL with
    first_slice_segment_in_pic_flag starts a picture, non-VCL NALs before
    it belong to it, suffix SEI (type 40) to the picture before."""
    aus, cur, have_vcl = [], bytearray(), False
    for nal in nal_units(stream):
        ntype = (nal[0] >> 1) & 0x3F
        vcl = ntype < 32
        first = vcl and len(nal) > 2 and nal[2] >> 7 == 1
        if have_vcl and ntype != 40 and (not vcl or first):
            aus.append(bytes(cur))
            cur, have_vcl = bytearray(), False
        cur += b"\x00\x00\x00\x01" + nal
        have_vcl |= vcl
    if cur:
        aus.append(bytes(cur))
    return aus


def decode_hevc(stream: bytes, width: int, height: int) -> List[list]:
    """The 8-bit 4:2:0 pictures of an Annex-B stream in output order, each
    [y, u, v] uint8 arrays, by FFmpeg's HEVC decoder. A picture of
    another size or format raises RuntimeError."""
    avutil, avcodec = _load_av()
    dec = avcodec.avcodec_find_decoder_by_name(b"hevc")
    if not dec:
        raise RuntimeError("no decoder: FFmpeg was built without hevc")
    ctx = ctypes.c_void_p(avcodec.avcodec_alloc_context3(dec))
    frame = ctypes.c_void_p(avutil.av_frame_alloc())
    out = []

    def drain():
        while avcodec.avcodec_receive_frame(ctx, frame) == 0:
            base = frame.value
            data = (ctypes.c_void_p * 8).from_address(base)
            lines = (ctypes.c_int * 8).from_address(base + 64)
            w, h, _, fmt = (ctypes.c_int * 4).from_address(
                base + _AVFRAME_WIDTH)
            if (w, h, fmt) != (width, height, _PIX_FMT_YUV420P):
                raise RuntimeError(f"decoded a {w}x{h} picture of format "
                                   f"{fmt}, not {width}x{height} yuv420p")
            planes = []
            for k, (pw, ph) in enumerate(((w, h), (w // 2, h // 2),
                                          (w // 2, h // 2))):
                raw = ctypes.string_at(data[k], lines[k] * ph)
                planes.append(np.frombuffer(raw, np.uint8)
                              .reshape(ph, lines[k])[:, :pw].copy())
            out.append(planes)

    try:
        if avcodec.avcodec_open2(ctx, dec, None) != 0:
            raise RuntimeError("the hevc decoder did not open")
        for au in access_units(stream):
            pkt = ctypes.c_void_p(avcodec.av_packet_alloc())
            buf = avutil.av_mallocz(len(au) + 64)
            ctypes.memmove(buf, au, len(au))
            avcodec.av_packet_from_data(pkt, buf, len(au))
            avcodec.avcodec_send_packet(ctx, pkt)
            avcodec.av_packet_free(ctypes.byref(pkt))
            drain()
        avcodec.avcodec_send_packet(ctx, None)
        drain()
    finally:
        avutil.av_frame_free(ctypes.byref(frame))
        avcodec.avcodec_free_context(ctypes.byref(ctx))
    return out


def recon_mismatch(decoded, recon) -> int:
    """Samples in which a decoded picture differs from the encoder's
    reconstruction (planes of different shapes count every sample)."""
    bad = 0
    for d, r in zip(decoded, recon):
        d, r = np.asarray(d), np.asarray(r)
        bad += int((d != r).sum()) if d.shape == r.shape else max(d.size,
                                                                   r.size)
    return bad


def psnr(a: np.ndarray, b: np.ndarray, peak: int = 255) -> float:
    """PSNR in dB of plane a against plane b."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(peak * peak / mse)


def sad_surface(ref: torch.Tensor, src: torch.Tensor, srange: int,
                base: int) -> torch.Tensor:
    """[D, D, H/base, W/base] int32: the SAD of every base x base block of
    src against ref displaced by (dx, dy) in [-R, R]^2, reference samples
    outside the plane taken from its nearest edge."""
    R = srange
    D = 2 * R + 1
    H, W = src.shape
    padded = torch.nn.functional.pad(ref.to(torch.float32)[None, None],
                                     (R, R, R, R), mode="replicate")[0, 0]
    padded = padded.to(torch.int32)
    s = src.to(torch.int32)
    out = torch.empty((D, D, H // base, W // base), dtype=torch.int32,
                      device=src.device)
    for j in range(D):                       # dy = j - R
        rows = padded[j:j + H]               # [H, W + 2R]
        for i in range(D):                   # dx = i - R
            d = (rows[:, i:i + W] - s).abs()
            out[j, i] = d.reshape(H // base, base, W // base, base) \
                .sum(dim=(1, 3))
    return out


def best_moves(surface: torch.Tensor, n: int, srange: int, lam: int,
               base: int = 8):
    """(mvx, mvy, sad) int32 [blocks] of the n x n blocks in raster order
    from a base x base surface: the least SAD + lam * (|dx| + |dy|), the
    first in (dy, dx) row-major order."""
    D, _, hb, wb = surface.shape
    f = n // base
    s = surface.to(torch.int64).reshape(D, D, hb // f, f, wb // f, f) \
        .sum(dim=(3, 5)).reshape(D * D, -1)
    d = (torch.arange(D, device=surface.device) - srange).abs()
    cost = s + (lam * (d[:, None] + d[None, :])).reshape(D * D, 1)
    least = cost.min(dim=0).values
    idx = torch.arange(D * D, device=surface.device)[:, None]
    first = torch.where(cost == least, idx, D * D).min(dim=0).values
    sad = s.gather(0, first[None])[0]
    return ((first % D - srange).to(torch.int32),
            (first // D - srange).to(torch.int32), sad.to(torch.int32))
