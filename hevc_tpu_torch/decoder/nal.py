"""Annex-B parsing: start-code scan, EBSP->RBSP, NAL headers, BitReader.

Behavioral counterpart of the reference's AnnexBread.cpp / NALread.cpp;
BitReader mirrors ..entropy.bitstream.BitWriter field-for-field.
"""

from __future__ import annotations

from typing import List, NamedTuple


class StreamError(ValueError):
    """A stream the decoder cannot take: corrupt, or outside its
    toolset."""


def require(cond: bool, what: str):
    """Raise StreamError(what) unless cond holds (a check on the input
    stream, kept under `python -O`)."""
    if not cond:
        raise StreamError(what)


def ebsp_to_rbsp(data: bytes) -> bytes:
    """Strip emulation_prevention_three_byte (inverse of rbsp_to_ebsp)."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


class NalUnit(NamedTuple):
    nal_type: int
    layer_id: int
    temporal_id: int
    rbsp: bytes


def split_annexb(stream: bytes) -> List[NalUnit]:
    """Split an Annex-B byte stream into NAL units (7.4.2 framing)."""
    units = []
    n = len(stream)
    i = stream.find(b"\x00\x00\x01")
    while i != -1 and i + 3 < n:
        start = i + 3
        j = stream.find(b"\x00\x00\x01", start)
        end = j if j != -1 else n
        # trailing zeros before the next start code belong to it
        payload_end = end
        while payload_end > start and stream[payload_end - 1] == 0 \
                and j != -1:
            payload_end -= 1
        ebsp = stream[start:payload_end]
        if len(ebsp) >= 2:
            h0, h1 = ebsp[0], ebsp[1]
            units.append(NalUnit(
                nal_type=(h0 >> 1) & 0x3F,
                layer_id=((h0 & 1) << 5) | (h1 >> 3),
                temporal_id=(h1 & 7) - 1,
                rbsp=ebsp_to_rbsp(ebsp[2:])))
        i = j
    return units


class BitReader:
    """MSB-first bit reader over an RBSP byte string."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0       # byte position
        self.bit = 0       # bit within byte (0 = MSB next)

    def u(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            require(self.pos < len(self.data), "bitstream exhausted")
            v = (v << 1) | ((self.data[self.pos] >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            require(zeros < 64, "corrupt exp-Golomb")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def byte_align(self):
        """rbsp byte_alignment(): one 1 bit then zeros to the boundary."""
        if self.bit != 0:
            one = self.u(1)
            require(one == 1, "alignment stop bit missing")
            while self.bit != 0:
                self.u(1)

    def remaining_bytes(self) -> bytes:
        require(self.bit == 0, "not byte aligned")
        return self.data[self.pos:]
