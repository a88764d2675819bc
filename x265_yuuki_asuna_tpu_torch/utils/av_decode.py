"""Independent HEVC decoding through the FFmpeg libavcodec that ships
inside the opencv-python wheel, driven through ctypes (the port's copy of
x265_yuuki_asuna_tpu/utils/av_decode.py): the exact Y / U / V planes, no
colour conversion in the way. Importing needs no cv2: available() is
False without it (or without the libraries its wheel ships), and
decode_hevc then raises. No encode path imports this module.

avcodec 62 ABI: AVFrame begins with uint8_t *data[8]; int linesize[8];
the only fields read, with the picture's geometry from the caller.
"""

from __future__ import annotations

import ctypes
import glob
import os
from typing import List, Optional, Tuple

import numpy as np

_AV = None


def _load():
    global _AV
    if _AV is not None:
        return _AV
    import cv2
    root = os.path.join(os.path.dirname(cv2.__file__), "..", "opencv_python.libs")
    avutil = ctypes.CDLL(glob.glob(os.path.join(root, "libavutil*.so*"))[0],
                         mode=ctypes.RTLD_GLOBAL)
    avcodec = ctypes.CDLL(glob.glob(os.path.join(root, "libavcodec*.so*"))[0],
                          mode=ctypes.RTLD_GLOBAL)

    avcodec.avcodec_find_decoder_by_name.restype = ctypes.c_void_p
    avcodec.avcodec_find_decoder_by_name.argtypes = [ctypes.c_char_p]
    avcodec.avcodec_alloc_context3.restype = ctypes.c_void_p
    avcodec.avcodec_alloc_context3.argtypes = [ctypes.c_void_p]
    avcodec.avcodec_open2.restype = ctypes.c_int
    avcodec.avcodec_open2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    avcodec.av_packet_alloc.restype = ctypes.c_void_p
    avutil.av_frame_alloc.restype = ctypes.c_void_p
    avcodec.avcodec_send_packet.restype = ctypes.c_int
    avcodec.avcodec_send_packet.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    avcodec.avcodec_receive_frame.restype = ctypes.c_int
    avcodec.avcodec_receive_frame.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    avcodec.av_packet_from_data.restype = ctypes.c_int
    avcodec.av_packet_from_data.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    avutil.av_malloc.restype = ctypes.c_void_p
    avutil.av_malloc.argtypes = [ctypes.c_size_t]
    _AV = (avutil, avcodec)
    return _AV


def available() -> bool:
    try:
        _load()
        return True
    except (ImportError, OSError, IndexError):
        return False


def decode_hevc(stream: bytes, width: int, height: int,
                bit_depth: int = 8, csp_shifts: Tuple[int, int] = (1, 1)
                ) -> List[Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]]:
    """Decode an Annex-B HEVC elementary stream; returns per-frame (Y, U, V)
    numpy planes (exact decoder output, padded dims cropped by caller)."""
    avutil, avcodec = _load()
    dec = avcodec.avcodec_find_decoder_by_name(b"hevc")
    assert dec, "hevc decoder missing"
    ctx = avcodec.avcodec_alloc_context3(ctypes.c_void_p(dec))
    assert avcodec.avcodec_open2(ctypes.c_void_p(ctx), ctypes.c_void_p(dec), None) == 0

    frames = []

    def drain():
        frame = avutil.av_frame_alloc()
        while True:
            r = avcodec.avcodec_receive_frame(ctypes.c_void_p(ctx), ctypes.c_void_p(frame))
            if r != 0:
                break
            frames.append(_read_planes(frame, width, height, bit_depth, csp_shifts))

    for au in split_access_units(stream):
        pkt = avcodec.av_packet_alloc()
        buf = avutil.av_malloc(len(au) + 64)
        ctypes.memmove(buf, au, len(au))
        assert avcodec.av_packet_from_data(ctypes.c_void_p(pkt),
                                           ctypes.c_void_p(buf), len(au)) == 0
        assert avcodec.avcodec_send_packet(ctypes.c_void_p(ctx),
                                           ctypes.c_void_p(pkt)) == 0
        drain()
    avcodec.avcodec_send_packet(ctypes.c_void_p(ctx), None)   # flush
    drain()
    return frames


def split_access_units(stream: bytes) -> List[bytes]:
    """Group an Annex-B stream into access units (one VCL NAL per AU here;
    leading non-VCL NALs attach forward, suffix SEI attaches backward)."""
    from ..bitstream.bitio import split_annexb
    aus: List[bytes] = []
    cur = bytearray()
    have_vcl = False
    for nal in split_annexb(stream):
        ntype = (nal[0] >> 1) & 0x3F
        is_vcl = ntype < 32
        # a VCL NAL starts a new AU only when first_slice_segment_in_pic_flag
        # is set (multi-slice pictures keep their slices in one AU)
        first_slice = is_vcl and len(nal) > 2 and (nal[2] >> 7) == 1
        is_suffix = ntype in (40, 45)   # suffix SEI / filler attach backward
        if have_vcl and not is_suffix and (not is_vcl or first_slice):
            aus.append(bytes(cur))
            cur = bytearray()
            have_vcl = False
        cur += b"\x00\x00\x00\x01" + nal
        if is_vcl:
            have_vcl = True
    if cur:
        aus.append(bytes(cur))
    return aus


def _read_planes(frame_ptr: int, width: int, height: int, bit_depth: int,
                 csp_shifts: Tuple[int, int]):
    data = (ctypes.c_void_p * 8).from_address(frame_ptr)
    linesize = (ctypes.c_int * 8).from_address(frame_ptr + 8 * ctypes.sizeof(ctypes.c_void_p))
    hs, ws = csp_shifts
    dt = np.uint16 if bit_depth > 8 else np.uint8
    bpp = 2 if bit_depth > 8 else 1

    def plane(idx, w, h):
        if not data[idx]:
            return None
        ls = linesize[idx]
        raw = ctypes.string_at(data[idx], ls * h)
        arr = np.frombuffer(raw, dtype=np.uint8).reshape(h, ls)
        arr = arr[:, :w * bpp]
        if bpp == 2:
            arr = arr.view(np.uint16)
        return arr.copy()

    y = plane(0, width, height)
    u = plane(1, width >> ws, height >> hs)
    v = plane(2, width >> ws, height >> hs)
    return y, u, v
