"""Decoded-picture-hash helpers (SEI payload, H.265 D.3.19) and the
normative NumPy TU coder.

The port's copy of the hash functions of the reference package's golden
encoder, and of its one-TB intra coder (`_predict_tu`, `_code_tu`), which
the intra-in-P re-code of P frames runs on the host
(pipeline/intra_p). The sequential NumPy encoder itself is not part of
the port (the tests use the reference package's as their oracle).
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..core import zorder
from ..ops import intra, quant, rdoq as rdoq_lib, transforms


def _predict_tu(plane, zmap, x0, y0, n, mode, *, component, pad_w, pad_h,
                scale=1):
    """Normative intra prediction of one TB from reconstructed samples."""
    r = zorder.gather_refs(plane, x0, y0, n)[None]
    avail = zorder.avail_mask(x0, y0, n, pad_w, pad_h, zmap, scale)[None]
    r = intra.substitute_refs_np(r, avail)
    if component == "luma" and intra.ref_filter_flag(mode, n):
        r = intra.filter_refs_np(r)
    return intra.predict_np(r, mode, n, component=component)[0]


def _code_tu(orig, recon, coef_out, zmap, x0, y0, n, mode, qp, *,
             component, pad_w, pad_h, scale=1, rdoq=True):
    """Encode one TB: predict -> transform -> quant -> recon in place."""
    pred = _predict_tu(recon, zmap, x0, y0, n, mode, component=component,
                       pad_w=pad_w, pad_h=pad_h, scale=scale)
    resi = orig[y0:y0 + n, x0:x0 + n].astype(np.int32) - pred
    use_dst = (component == "luma" and n == 4)
    coef = transforms.forward_transform_np(resi[None], use_dst=use_dst)[0]
    if rdoq:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        lvl = rdoq_lib.rd_quantize_np(coef[None], qp, lam,
                                      is_luma=component == "luma")[0]
    else:
        lvl = quant.quantize_np(coef[None], qp)[0]
    coef_out[y0:y0 + n, x0:x0 + n] = lvl
    if np.any(lvl):
        deq = quant.dequantize_np(lvl[None], qp)[0]
        rec_resi = transforms.inverse_transform_np(deq[None],
                                                   use_dst=use_dst)[0]
    else:
        rec_resi = 0
    recon[y0:y0 + n, x0:x0 + n] = np.clip(pred + rec_resi, 0, 255)


def md5_plane(plane: np.ndarray) -> bytes:
    return hashlib.md5(np.ascontiguousarray(plane, np.uint8)
                       .tobytes()).digest()


def crc_plane(plane: np.ndarray) -> bytes:
    """CRC-16 picture hash (D.3.19 hash_type 1): poly 0x1021 MSB-first,
    bit-serial init 0xFFFF with 16 zero bits appended (HM:
    TComPicYuvMD5.cpp compCRC).  Equivalent closed form: table-driven
    CRC-CCITT with init 0x1D0F (= 0xFFFF flushed through 16 feedback
    steps), i.e. CRC-16/AUG-CCITT — verified bit-identical to the
    bit-serial HM algorithm."""
    import binascii
    crc = binascii.crc_hqx(
        np.ascontiguousarray(plane, np.uint8).tobytes(), 0x1D0F)
    return bytes([(crc >> 8) & 0xFF, crc & 0xFF])


def checksum_plane(plane: np.ndarray) -> bytes:
    """Checksum picture hash (D.3.19 hash_type 2): 32-bit sum of
    sample ^ xorMask, xorMask = (x & 0xFF) ^ (y & 0xFF) ^ (x >> 8) ^
    (y >> 8). HM: TComPicYuvMD5.cpp compChecksum."""
    p = np.ascontiguousarray(plane, np.uint8)
    h, w = p.shape
    xs = np.arange(w, dtype=np.uint32)
    ys = np.arange(h, dtype=np.uint32)
    mask = ((xs[None, :] & 0xFF) ^ (ys[:, None] & 0xFF)
            ^ (xs[None, :] >> 8) ^ (ys[:, None] >> 8)).astype(np.uint32)
    s = int(((p.astype(np.uint32) ^ mask) & 0xFF).sum()) & 0xFFFFFFFF
    return s.to_bytes(4, "big")


HASH_TYPE_ID = {"md5": 0, "crc": 1, "checksum": 2}
_HASH_FN = {0: md5_plane, 1: crc_plane, 2: checksum_plane}


def pic_hashes(rec, hash_type: str = "md5"):
    """(hash_type_id, [h_y, h_cb, h_cr]) for a reconstructed picture."""
    tid = HASH_TYPE_ID[hash_type]
    fn = _HASH_FN[tid]
    return tid, [fn(rec.y), fn(rec.cb), fn(rec.cr)]
