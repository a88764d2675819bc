"""Bit-level writer and reader and NAL packaging (host copy of
x265_yuuki_asuna_tpu/bitstream/bitio.py: BitWriter, wrap_nal,
parse_annexb_nals; the reader's split_annexb, strip_emulation and
BitReader, which no encode path runs).

Reference behavior (studied, not copied): common/bitstream.h,
encoder/nal.cpp (start codes, emulation prevention).
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer (RBSP payload, pre-emulation-prevention)."""

    def __init__(self):
        self.buf = bytearray()
        self._cur = 0          # partial byte accumulator
        self._nbits = 0        # bits in accumulator [0, 8)

    def write_bits(self, value: int, nbits: int):
        assert nbits <= 32 and value >= 0 and \
            (nbits == 32 or value < (1 << nbits)), (value, nbits)
        while nbits > 0:
            take = min(8 - self._nbits, nbits)
            chunk = (value >> (nbits - take)) & ((1 << take) - 1)
            self._cur = (self._cur << take) | chunk
            self._nbits += take
            nbits -= take
            if self._nbits == 8:
                self.buf.append(self._cur)
                self._cur = 0
                self._nbits = 0

    def write_flag(self, flag):
        self.write_bits(1 if flag else 0, 1)

    def write_ue(self, value: int):
        """Exp-Golomb unsigned (ue(v))."""
        assert value >= 0
        length = (value + 1).bit_length()
        self.write_bits(0, length - 1)
        self.write_bits(value + 1, length)

    def write_se(self, value: int):
        """Exp-Golomb signed (se(v)): 0,1,-1,2,-2... -> 0,1,2,3,4..."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def write_bytes(self, data: bytes):
        assert self._nbits == 0, "stream not byte aligned"
        self.buf += data

    def write_align_zero(self):
        if self._nbits:
            self.write_bits(0, 8 - self._nbits)

    def rbsp_trailing_bits(self):
        self.write_bits(1, 1)
        self.write_align_zero()

    def get_bytes(self) -> bytes:
        assert self._nbits == 0, "stream not byte aligned"
        return bytes(self.buf)


def anti_emulation(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (0x03) so no 00 00 0x pattern
    (x<=3) appears in the NAL payload (spec 7.4.2)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


# NAL unit types (spec table 7-1)
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_RASL_N = 8      # an open GOP's leading pictures
NAL_IDR_W_RADL = 19
NAL_CRA = 21        # an open GOP's keyframe
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


def wrap_nal(nal_type: int, rbsp: bytes, temporal_id: int = 0) -> bytes:
    """Annex-B NAL: start code + 2-byte header + anti-emulated payload."""
    header = bytes([(nal_type << 1) & 0x7E, temporal_id + 1])
    return b"\x00\x00\x00\x01" + header + anti_emulation(rbsp)


def parse_annexb_nals(data: bytes):
    """Split an Annex-B byte stream into NAL payloads without their start
    codes and 2-byte headers (emulation-prevention bytes left in place:
    wrap_nal re-wraps each payload verbatim, adding a header). A NAL of
    two bytes or fewer is dropped. The RPU files' splitter: it trims
    zeros otherwise than the reader's split_annexb (one zero before a
    start code, all zeros after the last NAL), each as its reference
    does."""
    nals = []
    i = 0
    n = len(data)
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        j += 3
        k = data.find(b"\x00\x00\x01", j)
        end = n if k < 0 else (k - 1 if k > 0 and data[k - 1] == 0 else k)
        payload = data[j:end].rstrip(b"\x00") if k < 0 else data[j:end]
        if len(payload) > 2:
            nals.append(bytes(payload[2:]))
        i = j
    return nals


def strip_emulation(payload: bytes) -> bytes:
    """A NAL payload without its emulation-prevention bytes (the 0x03
    after two zero bytes and before a byte <= 3): the RBSP."""
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(payload):
        b = payload[i]
        if zeros >= 2 and b == 3 and i + 1 < len(payload) \
                and payload[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def split_annexb(data: bytes):
    """An Annex-B stream's NAL units, each its 2-byte header and payload
    without the start code (the zero bytes before a following start code
    trimmed, the last NAL's kept): the reader's splitter."""
    starts = []
    i, n = 0, len(data)
    while i < n - 3:
        if data[i] == 0 and data[i + 1] == 0:
            if data[i + 2] == 1:
                starts.append(i + 3)
                i += 3
                continue
            if data[i + 2] == 0 and i + 3 < n and data[i + 3] == 1:
                starts.append(i + 4)
                i += 4
                continue
        i += 1
    nals = []
    for k, s in enumerate(starts):
        end = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        while end > s and data[end - 1] == 0 and k + 1 < len(starts):
            end -= 1
        nals.append(data[s:end])
    return nals


class BitReader:
    """MSB-first reader over an RBSP: fixed-length fields, ue(v) and
    se(v) (spec 9.2)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0           # bit position

    def read_bits(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def read_flag(self) -> int:
        return self.read_bits(1)

    def read_ue(self) -> int:
        zeros = 0
        while self.read_bits(1) == 0:
            zeros += 1
            if zeros >= 32:
                raise ValueError("ue(v) with 32 leading zero bits")
        return (1 << zeros) - 1 + (self.read_bits(zeros) if zeros else 0)

    def read_se(self) -> int:
        k = self.read_ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)

    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def more_rbsp_data(self) -> bool:
        return self.pos < len(self.data) * 8 - 8
