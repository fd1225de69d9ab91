"""Standalone HEVC decoder for the framework's toolset.

Counterpart of the reference HM decoder library (TLibDecoder:
TDecTop.cpp:725, TDecSlice.cpp:69, TDecCu.cpp:128,
TDecSbac/TDecBinCoderCABAC) restricted to the toolset the encoder emits:
Main profile 4:2:0 8-bit, one slice per picture, CTU 64 depth 4, I (IDR)
slices with intra NxN, P and low-delay B slices (uni-L0 motion, 1-4
references, merge/skip, AMVP, rectangular PUs, intra CUs), deblocking,
SAO, cu_qp_delta at CTB granularity.

The CABAC/syntax layer is host Python (sequential by nature, sharing the
encoder's tables in ..entropy); the intra reconstruction runs on the
host through the encoder's normative NumPy twins, the inter prediction
and the in-loop filters on the decoder's device through the encoder's
ops (..ops.inter, ..ops.deblock, ..ops.sao).

Primary entry: decode_annexb(stream, device=None) -> DecodeResult.
"""

from .top import DecodeResult, decode_annexb, decode_file

__all__ = ["DecodeResult", "decode_annexb", "decode_file"]
