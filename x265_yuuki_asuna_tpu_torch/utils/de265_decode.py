"""libde265 HEVC decoder binding through ctypes (a second decoder beside
av_decode.py; the port's copy of x265_yuuki_asuna_tpu/utils/de265_decode.py).

With the deblock and SAO both on, libavcodec classifies chroma edge
offsets at the junction of four CTBs from partly deblocked samples, where
the spec (8.7.2, then 8.7.3) deblocks the whole picture first; libde265
follows the spec, so the loop-filter tests decode with it. It also
decodes CTBs of 8, which libavcodec refuses. available() is False where
the library is missing. No encode path imports this module.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import List, Optional

import numpy as np

_LIB = None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    for name in ("libde265.so.0", "libde265.so",
                 ctypes.util.find_library("de265") or ""):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.de265_new_decoder.restype = ctypes.c_void_p
        lib.de265_free_decoder.argtypes = [ctypes.c_void_p]
        lib.de265_push_data.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int, ctypes.c_longlong,
                                        ctypes.c_void_p]
        lib.de265_flush_data.argtypes = [ctypes.c_void_p]
        lib.de265_decode.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int)]
        lib.de265_get_next_picture.argtypes = [ctypes.c_void_p]
        lib.de265_get_next_picture.restype = ctypes.c_void_p
        lib.de265_get_image_plane.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int)]
        lib.de265_get_image_plane.restype = ctypes.POINTER(ctypes.c_ubyte)
        lib.de265_get_image_width.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.de265_get_image_height.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.de265_get_bits_per_pixel.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
        _LIB = lib
        return lib
    return None


def available() -> bool:
    return _load() is not None


def decode_hevc_de265(stream: bytes, max_frames: int = 10000) -> List[list]:
    """Decode an Annex-B HEVC stream; returns per-frame [y, u, v] numpy
    planes (uint8 for 8-bit, uint16 view for >8-bit)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libde265 not available")
    ctx = lib.de265_new_decoder()
    try:
        lib.de265_push_data(ctx, stream, len(stream), 0, None)
        lib.de265_flush_data(ctx)
        out = []
        for _ in range(max_frames * 4):
            more = ctypes.c_int(1)
            lib.de265_decode(ctx, ctypes.byref(more))
            img = lib.de265_get_next_picture(ctx)
            if img:
                planes = []
                for ch in range(3):
                    stride = ctypes.c_int()
                    ptr = lib.de265_get_image_plane(img, ch,
                                                    ctypes.byref(stride))
                    ww = lib.de265_get_image_width(img, ch)
                    hh = lib.de265_get_image_height(img, ch)
                    bpp = lib.de265_get_bits_per_pixel(img, ch)
                    if bpp > 8:
                        buf = np.ctypeslib.as_array(
                            ptr, (hh, stride.value))
                        arr = buf.view(np.uint8).reshape(hh, -1) \
                            .view("<u2")[:, :ww].copy()
                    else:
                        buf = np.ctypeslib.as_array(ptr, (hh, stride.value))
                        arr = buf[:, :ww].copy()
                    planes.append(arr)
                out.append(planes)
                if len(out) >= max_frames:
                    break
            if not more.value:
                break
        return out
    finally:
        lib.de265_free_decoder(ctx)
