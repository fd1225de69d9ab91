"""Golden (NumPy) All-Intra frame encoder, the decoded-picture-hash
helpers (SEI payload, H.265 D.3.19) and the normative NumPy TU coder.

Sequential host implementation of the full AI coding chain: CU quadtree
from a depth map, per-TU intra prediction from reconstructed neighbours,
forward transform, quant, dequant, inverse transform, reconstruction and
entropy packing. It is the oracle the device reconstructions are held to
and the `"golden"` reconstruction backend of `pipeline/ai.AIEncoder`; its
one-TB coder (`_predict_tu`, `_code_tu`) also serves the intra-in-P
re-code of P frames (pipeline/intra_p).

Call stack counterpart in the reference encoder: TEncSlice::compressSlice
-> TEncCu::xCompressCU -> TEncSearch::estIntraPredLumaQT, with the RDO
search replaced by (a) supplied depth decisions (HCPM-style) and (b)
SATD+mode-bits intra mode selection.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..core import zorder
from ..core.yuv import Frame, pad_frame
from ..entropy import headers
from ..entropy.slice_enc import SliceEncoder, mpm_list
from ..ops import cost, intra, quant, rdoq as rdoq_lib, transforms

PLANAR, DC, HOR, VER = 0, 1, 10, 26


def _predict_tu(plane, zmap, x0, y0, n, mode, *, component, pad_w, pad_h,
                scale=1):
    """Normative intra prediction of one TB from reconstructed samples."""
    r = zorder.gather_refs(plane, x0, y0, n)[None]
    avail = zorder.avail_mask(x0, y0, n, pad_w, pad_h, zmap, scale)[None]
    r = intra.substitute_refs_np(r, avail)
    if component == "luma" and intra.ref_filter_flag(mode, n):
        r = intra.filter_refs_np(r)
    return intra.predict_np(r, mode, n, component=component)[0]


def _all_mode_preds(plane, zmap, x0, y0, n, *, pad_w, pad_h):
    """[35, n, n] luma predictions (both filtered/unfiltered refs)."""
    r = zorder.gather_refs(plane, x0, y0, n)[None]
    avail = zorder.avail_mask(x0, y0, n, pad_w, pad_h, zmap)[None]
    r = intra.substitute_refs_np(r, avail)
    rf = intra.filter_refs_np(r)
    preds = np.zeros((35, n, n), np.int32)
    for mode in range(35):
        use = rf if intra.ref_filter_flag(mode, n) else r
        preds[mode] = intra.predict_np(use, mode, n, component="luma")[0]
    return preds


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


def choose_mode_satd(recon_y, zmap, x0, y0, n, orig_y, lam_sqrt, mpm,
                     pad_w, pad_h):
    """SATD + mode-bits intra mode decision (HM RMD-style preselection)."""
    preds = _all_mode_preds(recon_y, zmap, x0, y0, n, pad_w=pad_w,
                            pad_h=pad_h)
    o = orig_y[y0:y0 + n, x0:x0 + n].astype(np.int32)[None]
    block = 4 if n == 4 else 8
    satds = cost.satd_np(np.repeat(o, 35, 0), preds, block=block)
    bits = np.full(35, 5.0 + 1.0)
    for i, m in enumerate(mpm):
        bits[m] = 1.0 + (1.0 if i == 0 else 2.0)
    costs = satds + lam_sqrt * bits
    return int(np.argmin(costs))


class GoldenEncoder:
    """Sequential AI encoder for one sequence at fixed QP (`cfg.qp`)."""

    def __init__(self, cfg: headers.EncoderConfig):
        self.cfg = cfg
        self.zmap = zorder.frame_zmap(cfg.pad_width, cfg.pad_height)

    def encode_frame(self, frame: Frame, depth8: np.ndarray,
                     modes8: np.ndarray = None, modes4: np.ndarray = None,
                     nxn8: np.ndarray = None):
        """Encode one frame.

        depth8: [H/8, W/8] CU depth map (decisions, e.g. from HCPM gating).
        modes8: optional fixed intra modes; None = SATD-select per CU.
        modes4/nxn8: NxN part-mode decisions at depth-3 CUs ([H/4, W/4]
        per-PU modes + [H/8, W/8] flags); None = all 2Nx2N.
        Returns (decisions dict, recon Frame).
        """
        cfg = self.cfg
        qp = cfg.qp
        W, H = cfg.pad_width, cfg.pad_height
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        lam_sqrt = np.sqrt(lam)

        orig_y = frame.y.astype(np.int32)
        orig_cb = frame.cb.astype(np.int32)
        orig_cr = frame.cr.astype(np.int32)
        recon_y = np.zeros((H, W), np.int32)
        recon_cb = np.zeros((H // 2, W // 2), np.int32)
        recon_cr = np.zeros((H // 2, W // 2), np.int32)
        coef_y = np.zeros((H, W), np.int32)
        coef_cb = np.zeros((H // 2, W // 2), np.int32)
        coef_cr = np.zeros((H // 2, W // 2), np.int32)
        out_modes8 = np.zeros((H // 8, W // 8), np.int32)
        out_modes4 = np.zeros((H // 4, W // 4), np.int32)

        cqp = quant.chroma_qp(qp)
        rdoq_on = getattr(cfg, "rdoq", True)
        luma = dict(component="luma", pad_w=W, pad_h=H, rdoq=rdoq_on)
        chroma = dict(component="chroma", pad_w=W // 2, pad_h=H // 2,
                      scale=2, rdoq=rdoq_on)

        def code_chroma(cx, cy, n, mode):
            for orig_c, recon_c, coef_c in ((orig_cb, recon_cb, coef_cb),
                                            (orig_cr, recon_cr, coef_cr)):
                _code_tu(orig_c, recon_c, coef_c, self.zmap, cx, cy, n,
                         mode, cqp, **chroma)

        def code_cu(x0, y0, size):
            is_nxn = (size == 8 and nxn8 is not None
                      and bool(nxn8[y0 >> 3, x0 >> 3]))
            if is_nxn:
                # four 4x4 PUs == TUs in z-order, per-PU modes (DST luma);
                # chroma is one 4x4 TB predicted with the PU0 (DM) mode
                pu_modes = []
                for (dx, dy) in ((0, 0), (4, 0), (0, 4), (4, 4)):
                    m = int(modes4[(y0 + dy) >> 2, (x0 + dx) >> 2])
                    pu_modes.append(m)
                    out_modes4[(y0 + dy) >> 2, (x0 + dx) >> 2] = m
                    _code_tu(orig_y, recon_y, coef_y, self.zmap,
                             x0 + dx, y0 + dy, 4, m, qp, **luma)
                out_modes8[y0 >> 3, x0 >> 3] = pu_modes[0]
                code_chroma(x0 >> 1, y0 >> 1, 4, pu_modes[0])
                return

            mpm = self._mpm_for(out_modes8, x0, y0)
            if modes8 is not None:
                mode = int(modes8[y0 >> 3, x0 >> 3])
            else:
                mode = choose_mode_satd(recon_y, self.zmap, x0, y0,
                                        min(size, 32), orig_y, lam_sqrt,
                                        mpm, W, H)
            out_modes8[y0 >> 3:(y0 + size) >> 3,
                       x0 >> 3:(x0 + size) >> 3] = mode
            out_modes4[y0 >> 2:(y0 + size) >> 2,
                       x0 >> 2:(x0 + size) >> 2] = mode

            if size == 64:
                # four 32x32 luma TUs, then four 16x16 TBs per chroma plane
                for (dx, dy) in ((0, 0), (32, 0), (0, 32), (32, 32)):
                    _code_tu(orig_y, recon_y, coef_y, self.zmap,
                             x0 + dx, y0 + dy, 32, mode, qp, **luma)
                for (dx, dy) in ((0, 0), (16, 0), (0, 16), (16, 16)):
                    code_chroma((x0 >> 1) + dx, (y0 >> 1) + dy, 16, mode)
            else:
                _code_tu(orig_y, recon_y, coef_y, self.zmap, x0, y0, size,
                         mode, qp, **luma)
                code_chroma(x0 >> 1, y0 >> 1, size >> 1, mode)

        def walk(x0, y0, size, depth):
            if x0 >= W or y0 >= H:
                return
            inside = (x0 + size <= W) and (y0 + size <= H)
            split = (not inside and size > 8) or \
                (inside and depth8[y0 >> 3, x0 >> 3] > depth)
            if split:
                h = size >> 1
                for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):
                    walk(x0 + dx, y0 + dy, h, depth + 1)
            else:
                code_cu(x0, y0, size)

        for ci in range(cfg.ctus_x * cfg.ctus_y):
            cy, cx = divmod(ci, cfg.ctus_x)
            walk(cx * 64, cy * 64, 64, 0)

        out_nxn8 = (np.asarray(nxn8, bool) if nxn8 is not None
                    else np.zeros_like(out_modes8, bool))
        decisions = dict(depth8=depth8, modes8=out_modes8, coef_y=coef_y,
                         coef_cb=coef_cb, coef_cr=coef_cr,
                         modes4=out_modes4, nxn8=out_nxn8)
        recon = Frame(recon_y.astype(np.uint8), recon_cb.astype(np.uint8),
                      recon_cr.astype(np.uint8))
        return decisions, recon

    def _mpm_for(self, modes8, x0, y0):
        cand_a = DC if x0 == 0 else int(modes8[y0 >> 3, (x0 - 1) >> 3])
        cand_b = DC
        if y0 > 0 and (y0 - 1) >> 6 == y0 >> 6:
            cand_b = int(modes8[(y0 - 1) >> 3, x0 >> 3])
        return mpm_list(cand_a, cand_b)


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


def encode_sequence(frames, cfg: headers.EncoderConfig, depth8_fn,
                    with_hash_sei: bool = True):
    """Encode frames to a full Annex-B stream. depth8_fn(frame_idx, frame)
    -> [H/8, W/8] depth decisions. Returns (bytes, recons list)."""
    enc = GoldenEncoder(cfg)
    chunks = [headers.write_vps(cfg), headers.write_sps(cfg),
              headers.write_pps(cfg)]
    recons = []
    for i, frame in enumerate(frames):
        pf = pad_frame(frame, cfg.pad_width, cfg.pad_height)
        depth8 = depth8_fn(i, pf)
        decisions, recon = enc.encode_frame(pf, depth8)
        bw = headers.start_idr_slice(cfg, cfg.qp)
        se = SliceEncoder(cfg, cfg.qp)
        se.encode(bw, decisions["depth8"], decisions["modes8"],
                  decisions["coef_y"], decisions["coef_cb"],
                  decisions["coef_cr"])
        chunks.append(headers.finish_slice_nal(bw))
        if with_hash_sei:
            tid, hs = pic_hashes(recon, cfg.hash_type)
            chunks.append(headers.write_hash_sei(*hs, hash_type=tid))
        recons.append(recon)
    return b"".join(chunks), recons
