"""Raw video I/O: Y4M and YUV readers and writers, and the Annex-B
stream writer (port's copy of x265_yuuki_asuna_tpu/utils/io.py: VideoInfo,
Y4MReader, YUVReader, open_input, PrefetchReader, Y4MWriter, YUVWriter,
RawBitstreamWriter, ReconPlay; numpy on the host).

Reference behavior studied (not copied): input/y4m.cpp, input/yuv.cpp,
output/raw.cpp, output/y4m.cpp, output/yuv.cpp, output/reconplay.cpp.
"""

from __future__ import annotations

import os
import queue
import shlex
import subprocess
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from .param import CSP_I400, CSP_I420, CSP_I422, CSP_I444

_CSP_TAGS = {
    "420": CSP_I420, "420jpeg": CSP_I420, "420mpeg2": CSP_I420,
    "420paldv": CSP_I420, "420p10": CSP_I420, "420p12": CSP_I420,
    "422": CSP_I422, "422p10": CSP_I422, "422p12": CSP_I422,
    "444": CSP_I444, "444p10": CSP_I444, "444p12": CSP_I444,
    "mono": CSP_I400, "mono10": CSP_I400, "mono12": CSP_I400,
}


@dataclass
class VideoInfo:
    width: int
    height: int
    fps_num: int
    fps_denom: int
    csp: int
    bit_depth: int
    frame_count: Optional[int] = None

    @property
    def chroma_shifts(self) -> Tuple[int, int]:
        return {CSP_I400: (0, 0), CSP_I420: (1, 1),
                CSP_I422: (0, 1), CSP_I444: (0, 0)}[self.csp]

    @property
    def frame_bytes(self) -> int:
        hs, ws = self.chroma_shifts
        luma = self.width * self.height
        if self.csp == CSP_I400:
            chroma = 0
        else:
            chroma = 2 * ((self.width >> ws) * (self.height >> hs))
        pix = luma + chroma
        return pix * (2 if self.bit_depth > 8 else 1)


def _read_planes(data: bytes, info: VideoInfo):
    """Split one raw frame buffer into (Y, U, V) numpy planes."""
    dt = np.uint16 if info.bit_depth > 8 else np.uint8
    # a writable buffer: the planes go to torch tensors
    arr = np.frombuffer(bytearray(data), dtype=dt)
    hs, ws = info.chroma_shifts
    w, h = info.width, info.height
    y = arr[: w * h].reshape(h, w)
    if info.csp == CSP_I400:
        return y, None, None
    cw, ch = w >> ws, h >> hs
    u = arr[w * h: w * h + cw * ch].reshape(ch, cw)
    v = arr[w * h + cw * ch:].reshape(ch, cw)
    return y, u, v


class Y4MReader:
    """Parses the YUV4MPEG2 stream header + per-frame FRAME markers."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        header = self.f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"{path}: not a y4m file")
        w = h = 0
        fps_num, fps_denom = 25, 1
        csp, depth = CSP_I420, 8
        for tok in header.split()[1:]:
            tag, val = tok[0], tok[1:]
            if tag == "W":
                w = int(val)
            elif tag == "H":
                h = int(val)
            elif tag == "F":
                fps_num, fps_denom = (int(x) for x in val.split(":"))
            elif tag == "C":
                if val.endswith(("p10", "p12")):
                    depth = int(val[-2:])
                key = val if val in _CSP_TAGS else val.rstrip("p01246")
                csp = _CSP_TAGS.get(val, _CSP_TAGS.get(key, CSP_I420))
        self.info = VideoInfo(w, h, fps_num, fps_denom, csp, depth)
        self._data_start = self.f.tell()
        # count frames from file size (regular files only)
        try:
            size = os.fstat(self.f.fileno()).st_size
            per = self.info.frame_bytes + 6  # b"FRAME\n"
            self.info.frame_count = max(0, (size - self._data_start) // per)
        except OSError:
            pass

    def read_frame(self):
        marker = self.f.readline()
        if not marker:
            return None
        if not marker.startswith(b"FRAME"):
            raise ValueError("bad FRAME marker")
        data = self.f.read(self.info.frame_bytes)
        if len(data) < self.info.frame_bytes:
            return None
        return _read_planes(data, self.info)

    def close(self):
        self.f.close()


class YUVReader:
    """Raw planar YUV; dimensions/format must come from the caller."""

    def __init__(self, path: str, info: VideoInfo):
        self.f = open(path, "rb")
        self.info = info
        try:
            size = os.fstat(self.f.fileno()).st_size
            self.info.frame_count = size // info.frame_bytes
        except OSError:
            pass

    def read_frame(self):
        data = self.f.read(self.info.frame_bytes)
        if len(data) < self.info.frame_bytes:
            return None
        return _read_planes(data, self.info)

    def close(self):
        self.f.close()


def open_input(path: str, width: int = 0, height: int = 0, fps: Tuple[int, int] = (25, 1),
               csp: int = CSP_I420, bit_depth: int = 8):
    if path.endswith(".y4m"):
        return Y4MReader(path)
    info = VideoInfo(width, height, fps[0], fps[1], csp, bit_depth)
    return YUVReader(path, info)


class PrefetchReader:
    """Reads a reader's frames on a background thread, up to `depth`
    ahead (the reference's y4m ring buffer); iterate it for the frames in
    order. close() stops the thread and closes the reader."""

    def __init__(self, reader, depth: int = 4):
        self.reader = reader
        self.info = reader.info
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self._stop:
            frame = self.reader.read_frame()
            self.q.put(frame)
            if frame is None:
                break

    def close(self):
        self._stop = True
        while self.thread.is_alive():       # unblock a pending put
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                pass
        self.reader.close()

    def __iter__(self) -> Iterator:
        while True:
            frame = self.q.get()
            if frame is None:
                return
            yield frame


def _y4m_header(info: "VideoInfo") -> bytes:
    ctag = {CSP_I420: "420", CSP_I422: "422", CSP_I444: "444",
            CSP_I400: "mono"}[info.csp]
    if info.bit_depth > 8:
        ctag += f"p{info.bit_depth}"
    return (f"YUV4MPEG2 W{info.width} H{info.height} "
            f"F{info.fps_num}:{info.fps_denom} Ip A1:1 C{ctag}\n"
            .encode("ascii"))


class Y4MWriter:
    def __init__(self, path: str, info: VideoInfo):
        self.f = open(path, "wb")
        self.info = info
        self.f.write(_y4m_header(info))

    def write_frame(self, y, u, v):
        self.f.write(b"FRAME\n")
        self.f.write(np.ascontiguousarray(y).tobytes())
        if u is not None:
            self.f.write(np.ascontiguousarray(u).tobytes())
            self.f.write(np.ascontiguousarray(v).tobytes())

    def close(self):
        self.f.close()


class ReconPlay:
    """Pipes recon frames as y4m into a command's standard input (the
    reference's reconplay, e.g. a player reading stdin). A command that
    has closed its input is no longer written to; close() waits up to
    10 s for it to end."""

    def __init__(self, command: str, info: "VideoInfo"):
        self.proc = subprocess.Popen(shlex.split(command),
                                     stdin=subprocess.PIPE)
        self.info = info
        self.proc.stdin.write(_y4m_header(info))

    def write_frame(self, y, u, v):
        try:
            self.proc.stdin.write(b"FRAME\n")
            self.proc.stdin.write(np.ascontiguousarray(y).tobytes())
            if u is not None:
                self.proc.stdin.write(np.ascontiguousarray(u).tobytes())
                self.proc.stdin.write(np.ascontiguousarray(v).tobytes())
        except BrokenPipeError:
            pass

    def close(self):
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        self.proc.wait(timeout=10)


class YUVWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")

    def write_frame(self, y, u, v):
        self.f.write(np.ascontiguousarray(y).tobytes())
        if u is not None:
            self.f.write(np.ascontiguousarray(u).tobytes())
            self.f.write(np.ascontiguousarray(v).tobytes())

    def close(self):
        self.f.close()


class RawBitstreamWriter:
    """Annex-B elementary stream writer (reference: output/raw.cpp)."""

    def __init__(self, path: str):
        self.f = open(path, "wb") if path != "-" else None
        self.bytes_written = 0

    def write(self, nal_bytes: bytes):
        self.f.write(nal_bytes)
        self.bytes_written += len(nal_bytes)

    def close(self):
        if self.f:
            self.f.close()
