"""Bit-level writer and NAL packaging (host copy of
x265_yuuki_asuna_tpu/bitstream/bitio.py: BitWriter, wrap_nal).

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
NAL_IDR_W_RADL = 19
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


def wrap_nal(nal_type: int, rbsp: bytes, temporal_id: int = 0) -> bytes:
    """Annex-B NAL: start code + 2-byte header + anti-emulated payload."""
    header = bytes([(nal_type << 1) & 0x7E, temporal_id + 1])
    return b"\x00\x00\x00\x01" + header + anti_emulation(rbsp)
