"""CABAC arithmetic encoder (HM-style low / range) and decoder (spec
9.3.4.3), in Python.

Port of x265_yuuki_asuna_tpu/bitstream/cabac.py (`CabacEncoder`,
`CabacDecoder`). The decoder reads what the writers code, for the tests;
no encode path runs it. The sessions code their slices through the native
writer (`native.py`); this engine codes what that writer has no entry
for: the WPP substreams, one per CTU row, whose contexts carry from the
row above (`encoder_top.IntraEncoderSession._assemble_wpp`). It codes one
bin per Python call.

Reference behavior (studied, not copied): encoder/entropy.cpp
encodeBin / encodeBinEP / encodeBinsEP / encodeBinTrm / finish /
writeOut; spec 9.3.4.3.
"""

from __future__ import annotations

from .tables import (LPS_TABLE, TRANS_IDX_LPS, TRANS_IDX_MPS,
                     init_all_contexts)


class CabacEncoder:
    """Binary arithmetic encoder producing one slice's (or substream's)
    data bytes. ctx: the packed context states (pStateIdx << 1) | valMps
    (a bytearray; copy it to carry the states to another encoder)."""

    def __init__(self):
        self.out = bytearray()
        self.low = 0
        self.range = 510
        self.bits_left = -12
        self.num_buffered = 0
        self.buffered_byte = 0xFF
        self.ctx = None

    def init_contexts(self, slice_type: int, qp: int):
        self.ctx = init_all_contexts(slice_type, qp)

    def _write_out(self):
        lead = self.low >> (13 + self.bits_left)
        self.low &= (0xFFFFFFFF >> (19 - self.bits_left)) & 0xFFFFFFFF
        self.bits_left -= 8
        if lead == 0xFF:
            self.num_buffered += 1
        else:
            if self.num_buffered > 0:
                carry = lead >> 8
                self.out.append((self.buffered_byte + carry) & 0xFF)
                fill = (0xFF + carry) & 0xFF
                self.out += bytes([fill]) * (self.num_buffered - 1)
            self.num_buffered = 1
            self.buffered_byte = lead & 0xFF

    def encode_bin(self, binval: int, ctx_idx: int):
        mstate = self.ctx[ctx_idx]
        state, mps = mstate >> 1, mstate & 1
        lps = LPS_TABLE[state][(self.range >> 6) & 3]
        self.range -= lps
        if binval != mps:
            num_bits = 9 - lps.bit_length()
            self.low = (self.low + self.range) << num_bits
            self.range = lps << num_bits
            if state == 0:
                mps = 1 - mps
            self.ctx[ctx_idx] = (TRANS_IDX_LPS[state] << 1) | mps
            self.bits_left += num_bits
        else:
            self.ctx[ctx_idx] = (TRANS_IDX_MPS[state] << 1) | mps
            if self.range >= 256:
                return
            self.low <<= 1
            self.range <<= 1
            self.bits_left += 1
        if self.bits_left >= 0:
            self._write_out()

    def encode_bin_ep(self, binval: int):
        self.low <<= 1
        if binval:
            self.low += self.range
        self.bits_left += 1
        if self.bits_left >= 0:
            self._write_out()

    def encode_bins_ep(self, value: int, nbins: int):
        while nbins > 8:
            nbins -= 8
            pattern = value >> nbins
            self.low = (self.low << 8) + self.range * pattern
            value -= pattern << nbins
            self.bits_left += 8
            if self.bits_left >= 0:
                self._write_out()
        self.low = (self.low << nbins) + self.range * value
        self.bits_left += nbins
        if self.bits_left >= 0:
            self._write_out()

    def encode_bin_trm(self, binval: int):
        self.range -= 2
        if binval:
            self.low = (self.low + self.range) << 7
            self.range = 2 << 7
            self.bits_left += 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left += 1
        if self.bits_left >= 0:
            self._write_out()

    def finish(self) -> tuple:
        """Flush; returns (bytes, tail_value, tail_bits): the caller
        appends the tail bits to the byte-aligned data."""
        if self.low >> (21 + self.bits_left):
            self.out.append((self.buffered_byte + 1) & 0xFF)
            self.out += bytes(max(self.num_buffered - 1, 0))
            self.low -= 1 << (21 + self.bits_left)
        else:
            if self.num_buffered > 0:
                self.out.append(self.buffered_byte)
            self.out += b"\xff" * max(self.num_buffered - 1, 0)
        tail_bits = 13 + self.bits_left
        tail = (self.low >> 8) & ((1 << tail_bits) - 1) if tail_bits > 0 \
            else 0
        return bytes(self.out), tail, tail_bits


class CabacDecoder:
    """Spec 9.3.4.3 arithmetic decoder over a slice's RBSP from the bit
    start_bitpos (the slice data's first byte). ctx as CabacEncoder's."""

    def __init__(self, data: bytes, start_bitpos: int = 0):
        self.data = data
        self.bitpos = start_bitpos
        self.ctx = None
        self.range = 510                     # initialisation, 9.3.2.5
        self.offset = self._read_bits(9)

    def init_contexts(self, slice_type: int, qp: int):
        self.ctx = init_all_contexts(slice_type, qp)

    def _read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            i = self.bitpos >> 3
            bit = (self.data[i] >> (7 - (self.bitpos & 7))) & 1 \
                if i < len(self.data) else 0
            self.bitpos += 1
            v = (v << 1) | bit
        return v

    def decode_bin(self, ctx_idx: int) -> int:
        mstate = self.ctx[ctx_idx]
        state, mps = mstate >> 1, mstate & 1
        lps = int(LPS_TABLE[state][(self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:        # LPS
            self.offset -= self.range
            self.range = lps
            binval = 1 - mps
            if state == 0:
                mps = 1 - mps
            self.ctx[ctx_idx] = (int(TRANS_IDX_LPS[state]) << 1) | mps
        else:
            binval = mps
            self.ctx[ctx_idx] = (int(TRANS_IDX_MPS[state]) << 1) | mps
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        return binval

    def decode_bin_ep(self) -> int:
        self.offset = (self.offset << 1) | self._read_bits(1)
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bins_ep(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bin_ep()
        return v

    def decode_bin_trm(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        return 0
