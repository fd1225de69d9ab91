"""Slice-data CABAC decoding: I (intra, NxN) and P / low-delay B
(merge/skip, AMVP, rectangular PUs, intra CUs).

Syntax mirror of the I-slice coder ..entropy.slice_enc.SliceEncoder and
of the native P/B coder (..native, `hevc_encode_slice_p`); reference
counterparts: TDecSlice.cpp:69 CTU loop, TDecCu.cpp:128 decodeCtu,
TDecSbac.cpp parse* functions. Produces the same decision maps the
encoder's device pipeline emits: depth8 / modes4 / nxn8 / mvq8 / ref8 /
part8 / intra8 / coefficient planes (+ per-CTU SAO parameters), which
..decoder.recon_dec then reconstructs with the shared normative ops.
"""

from __future__ import annotations

import numpy as np

from ..core import zorder
from ..entropy import residual, scan as scanlib
from ..entropy.cabac import CabacDecoder
from ..entropy.contexts import ContextModels
from ..entropy.slice_enc import DC, mpm_list
from ..entropy import motion
from ..ops.sao import SaoParams, SAO_NONE, SAO_BAND, SAO_EDGE
from .nal import require


# ---------------------------------------------------------------------------
# SAO parameter decoding (mirror of entropy/sao_syntax.code_sao_ctu)
# ---------------------------------------------------------------------------

def _decode_type_idx(dec, ctx) -> int:
    if not dec.decode_bin(ctx, ctx.idx("sao_type")):
        return SAO_NONE
    return SAO_EDGE if dec.decode_bypass() else SAO_BAND


def _decode_offset_abs(dec) -> int:
    v = 0
    while v < 7 and dec.decode_bypass():
        v += 1
    return v


def decode_sao_ctu(dec, ctx, p: SaoParams, ci: int, cx: int, cy: int,
                   nx: int):
    """Decode CTU ci's SAO parameters into the SaoParams arrays."""
    def copy_from(src):
        p.type_idx[:, ci] = p.type_idx[:, src]
        p.eo_class[:, ci] = p.eo_class[:, src]
        p.band_pos[:, ci] = p.band_pos[:, src]
        p.offsets[:, ci] = p.offsets[:, src]

    if cx > 0 and dec.decode_bin(ctx, ctx.idx("sao_merge")):
        copy_from(ci - 1)
        return
    if cy > 0 and dec.decode_bin(ctx, ctx.idx("sao_merge")):
        copy_from(ci - nx)
        return
    for c in range(3):
        if c in (0, 1):
            t = _decode_type_idx(dec, ctx)
        else:
            t = int(p.type_idx[1, ci])       # Cr inherits Cb's type
        p.type_idx[c, ci] = t
        if t == SAO_NONE:
            continue
        offs = [_decode_offset_abs(dec) for _ in range(4)]
        if t == SAO_BAND:
            for k in range(4):
                if offs[k] != 0 and dec.decode_bypass():
                    offs[k] = -offs[k]
            p.band_pos[c, ci] = dec.decode_bypass_bins(5)
        else:
            if c in (0, 1):
                p.eo_class[c, ci] = dec.decode_bypass_bins(2)
            else:
                p.eo_class[c, ci] = p.eo_class[1, ci]
            # EO sign convention: categories 0,1 positive; 2,3 negative
            offs = [offs[0], offs[1], -offs[2], -offs[3]]
        p.offsets[c, ci] = offs


def _empty_sao(n_ctu: int) -> SaoParams:
    return SaoParams(type_idx=np.zeros((3, n_ctu), np.int32),
                     eo_class=np.zeros((3, n_ctu), np.int32),
                     band_pos=np.zeros((3, n_ctu), np.int32),
                     offsets=np.zeros((3, n_ctu, 4), np.int32))


# ---------------------------------------------------------------------------
# I slice
# ---------------------------------------------------------------------------

class ISliceDecoder:
    """Parses one I-slice payload into decision tensors."""

    def __init__(self, sps, qp: int, sao_on: bool,
                 cu_qp_delta: bool = False):
        self.W = sps.pad_width
        self.H = sps.pad_height
        self.nx = sps.ctus_x
        self.ny = sps.ctus_y
        self.qp = qp
        self.sao_on = sao_on
        self.cu_qp_delta = cu_qp_delta

    def decode(self, data: bytes):
        W, H = self.W, self.H
        self.depth8 = np.zeros((H >> 3, W >> 3), np.int32)
        self.modes4 = np.zeros((H >> 2, W >> 2), np.int32)
        self.nxn8 = np.zeros((H >> 3, W >> 3), bool)
        self.coef_y = np.zeros((H, W), np.int32)
        self.coef_cb = np.zeros((H >> 1, W >> 1), np.int32)
        self.coef_cr = np.zeros((H >> 1, W >> 1), np.int32)

        self.ctx = ContextModels(init_type=0, qp=self.qp)
        self.dec = CabacDecoder(data)
        n_ctu = self.nx * self.ny
        sao = _empty_sao(n_ctu) if self.sao_on else None
        for ci in range(n_ctu):
            cy, cx = divmod(ci, self.nx)
            if sao is not None:
                decode_sao_ctu(self.dec, self.ctx, sao, ci, cx, cy,
                               self.nx)
            self._dqp_pending = self.cu_qp_delta
            self._coding_quadtree(cx * 64, cy * 64, 64, 0)
            term = self.dec.decode_terminate()
            require(term == (1 if ci == n_ctu - 1 else 0),
                    f"end_of_slice at CTU {ci}")
        return dict(depth8=self.depth8, modes4=self.modes4,
                    nxn8=self.nxn8, coef_y=self.coef_y,
                    coef_cb=self.coef_cb, coef_cr=self.coef_cr,
                    sao=sao)

    def _parse_dqp0(self):
        """cu_qp_delta in an I slice of our streams: the encoder pins
        intra pictures at the slice QP, so the delta is always 0 —
        parse and verify (one bin on ctx dqp[0])."""
        if not self._dqp_pending:
            return
        self._dqp_pending = False
        a = self.dec.decode_bin(self.ctx, self.ctx.idx("dqp", 0))
        require(a == 0, "nonzero cu_qp_delta in I slice unsupported")

    # -- quadtree ---------------------------------------------------------
    def _coding_quadtree(self, x0, y0, size, depth):
        inside = (x0 + size <= self.W) and (y0 + size <= self.H)
        if inside and size > 8:
            ctx_inc = 0
            if x0 > 0:
                ctx_inc += int(self.depth8[y0 >> 3, (x0 - 1) >> 3] > depth)
            if y0 > 0:
                ctx_inc += int(self.depth8[(y0 - 1) >> 3, x0 >> 3] > depth)
            split = self.dec.decode_bin(
                self.ctx, self.ctx.idx("split_cu", ctx_inc))
        else:
            split = 1 if (not inside and size > 8) else 0
        if split:
            h = size >> 1
            for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < self.W and y1 < self.H:
                    self._coding_quadtree(x1, y1, h, depth + 1)
        else:
            self.depth8[y0 >> 3:(y0 + size) >> 3,
                        x0 >> 3:(x0 + size) >> 3] = depth
            self._coding_unit(x0, y0, size)

    # -- CU ---------------------------------------------------------------
    def _mode4_at(self, x, y):
        return int(self.modes4[y >> 2, x >> 2])

    def _mpm_for4(self, x, y):
        cand_a = DC if x == 0 else self._mode4_at(x - 1, y)
        cand_b = DC
        if y > 0 and (y - 1) >> 6 == y >> 6:
            cand_b = self._mode4_at(x, y - 1)
        return mpm_list(cand_a, cand_b)

    def _read_mpm_payload(self, in_mpm: int, mpm):
        if in_mpm:
            idx = 0
            if self.dec.decode_bypass():
                idx = 1 + self.dec.decode_bypass()
            return mpm[idx]
        rem = self.dec.decode_bypass_bins(5)
        for m in sorted(mpm):
            if rem >= m:
                rem += 1
        return rem

    def _coding_unit(self, x0, y0, size):
        dec, ctx = self.dec, self.ctx
        nxn = False
        if size == 8:
            nxn = dec.decode_bin(ctx, ctx.idx("part_mode", 0)) == 0
            self.nxn8[y0 >> 3, x0 >> 3] = nxn
        if nxn:
            pus = ((x0, y0), (x0 + 4, y0), (x0, y0 + 4), (x0 + 4, y0 + 4))
            flags = [dec.decode_bin(ctx, ctx.idx("prev_intra_luma_pred"))
                     for _ in range(4)]
            modes = []
            for (x, y), f in zip(pus, flags):
                # MPM depends on earlier PUs' decoded modes: fill as we go
                mpm = self._mpm_for4(x, y)
                m = self._read_mpm_payload(f, mpm)
                self.modes4[y >> 2, x >> 2] = m
                modes.append(m)
            dm = dec.decode_bin(ctx, ctx.idx("chroma_pred_mode"))
            require(dm == 0, "non-DM chroma modes not in toolset")
            self._transform_tree_nxn(x0, y0, modes)
            return

        in_mpm = dec.decode_bin(ctx, ctx.idx("prev_intra_luma_pred"))
        mpm = self._mpm_for4(x0, y0)
        mode = self._read_mpm_payload(in_mpm, mpm)
        self.modes4[y0 >> 2:(y0 + size) >> 2,
                    x0 >> 2:(x0 + size) >> 2] = mode
        dm = dec.decode_bin(ctx, ctx.idx("chroma_pred_mode"))
        require(dm == 0, "non-DM chroma modes not in toolset")
        self._transform_tree(x0, y0, size, 0, mode)

    # -- transform tree -----------------------------------------------------
    def _decode_residual_into(self, plane, x0, y0, n, scan_type, is_luma):
        blk = residual.decode_residual(self.dec, self.ctx, n,
                                       is_luma=is_luma, scan_type=scan_type)
        plane[y0:y0 + n, x0:x0 + n] = blk

    def _transform_tree(self, x0, y0, size, trafo_depth, luma_mode):
        dec, ctx = self.dec, self.ctx
        split = size > 32
        log2 = size.bit_length() - 1
        cbf_cb = cbf_cr = 0
        if log2 > 2:
            cbf_cb = dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma",
                                                 trafo_depth))
            cbf_cr = dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma",
                                                 trafo_depth))
        if split:
            h = size >> 1
            for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):
                self._transform_tree_child(x0 + dx, y0 + dy, h,
                                           trafo_depth + 1, luma_mode,
                                           cbf_cb, cbf_cr)
            return
        cbf_luma = dec.decode_bin(
            ctx, ctx.idx("qt_cbf_luma", 1 if trafo_depth == 0 else 0))
        self._transform_unit(x0, y0, size, cbf_luma, cbf_cb, cbf_cr,
                             luma_mode)

    def _transform_tree_child(self, x0, y0, size, trafo_depth, luma_mode,
                              parent_cbf_cb, parent_cbf_cr):
        dec, ctx = self.dec, self.ctx
        cbf_cb = (dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma", trafo_depth))
                  if parent_cbf_cb else 0)
        cbf_cr = (dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma", trafo_depth))
                  if parent_cbf_cr else 0)
        cbf_luma = dec.decode_bin(ctx, ctx.idx("qt_cbf_luma", 0))
        self._transform_unit(x0, y0, size, cbf_luma, cbf_cb, cbf_cr,
                             luma_mode)

    def _transform_tree_nxn(self, x0, y0, pu_modes):
        dec, ctx = self.dec, self.ctx
        cbf_cb = dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma", 0))
        cbf_cr = dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma", 0))
        for i, (dx, dy) in enumerate(((0, 0), (4, 0), (0, 4), (4, 4))):
            x1, y1 = x0 + dx, y0 + dy
            cl = dec.decode_bin(ctx, ctx.idx("qt_cbf_luma", 0))
            if cl or (i == 3 and (cbf_cb or cbf_cr)):
                self._parse_dqp0()
            if cl:
                st = scanlib.scan_type_for(pu_modes[i], 4, True)
                self._decode_residual_into(self.coef_y, x1, y1, 4, st, True)
            if i == 3:
                st = scanlib.scan_type_for(pu_modes[0], 4, False)
                if cbf_cb:
                    self._decode_residual_into(self.coef_cb, x0 >> 1,
                                               y0 >> 1, 4, st, False)
                if cbf_cr:
                    self._decode_residual_into(self.coef_cr, x0 >> 1,
                                               y0 >> 1, 4, st, False)

    def _transform_unit(self, x0, y0, size, cbf_luma, cbf_cb, cbf_cr,
                        luma_mode):
        if cbf_luma or cbf_cb or cbf_cr:
            self._parse_dqp0()
        if cbf_luma:
            st = scanlib.scan_type_for(luma_mode, size, True)
            self._decode_residual_into(self.coef_y, x0, y0, size, st, True)
        half = size >> 1
        if cbf_cb:
            st = scanlib.scan_type_for(luma_mode, half, False)
            self._decode_residual_into(self.coef_cb, x0 >> 1, y0 >> 1,
                                       half, st, False)
        if cbf_cr:
            st = scanlib.scan_type_for(luma_mode, half, False)
            self._decode_residual_into(self.coef_cr, x0 >> 1, y0 >> 1,
                                       half, st, False)


# ---------------------------------------------------------------------------
# P slice
# ---------------------------------------------------------------------------

class PSliceDecoder:
    """Parses one P- or low-delay-B-slice payload (uni-L0 toolset, 1-4
    references). B slices (is_b=True) carry inter_pred_idc per AMVP PU
    and have bi-predictive zero merge candidates; the toolset's motion
    field is uni-L0, so a PU that is bi-predictive or predicted from L1
    raises NotImplementedError instead of being decoded as L0."""

    def __init__(self, sps, qp: int, sao_on: bool, is_b: bool = False,
                 n_refs: int = 1, poc: int = 1, ref_pocs=None,
                 cu_qp_delta: bool = False):
        self.W = sps.pad_width
        self.H = sps.pad_height
        self.nx = sps.ctus_x
        self.ny = sps.ctus_y
        self.qp = qp
        self.cu_qp_delta = cu_qp_delta
        self.sao_on = sao_on
        self.is_b = is_b
        self.n_refs = n_refs
        self.poc = poc
        self.ref_pocs = (list(ref_pocs) if ref_pocs is not None
                         else [poc - 1 - i for i in range(n_refs)])
        self.zmap = zorder.frame_zmap(self.W, self.H)

    def decode(self, data: bytes):
        W, H = self.W, self.H
        self.depth8 = np.zeros((H >> 3, W >> 3), np.int32)
        self.mvq8 = np.zeros((H >> 3, W >> 3, 2), np.int32)
        self.ref8 = np.zeros((H >> 3, W >> 3), np.int32)
        self.skip8 = np.zeros((H >> 3, W >> 3), np.uint8)
        # intra-in-P state: inter8 is a live view the MotionField reads
        # (6.4.1: intra neighbours are unavailable for merge/AMVP)
        self.intra8 = np.zeros((H >> 3, W >> 3), bool)
        self.inter8 = np.ones((H >> 3, W >> 3), bool)
        self.part8 = np.zeros((H >> 3, W >> 3), np.int32)
        self.imodes4 = np.ones((H >> 2, W >> 2), np.int32)  # DC default
        self.field = motion.MotionField(self.mvq8, self.ref8, W, H,
                                        self.zmap, inter8=self.inter8)
        self.coef_y = np.zeros((H, W), np.int32)
        self.coef_cb = np.zeros((H >> 1, W >> 1), np.int32)
        self.coef_cr = np.zeros((H >> 1, W >> 1), np.int32)

        self.ctx = ContextModels(init_type=2 if self.is_b else 1,
                                 qp=self.qp)
        self.dec = CabacDecoder(data)
        # per-CTB QP (8.6.1 with diff_cu_qp_depth = 0: predictor ==
        # previous QG's QP in decoding order; slice QP at slice start)
        self.qp_ctb = np.full((self.ny, self.nx), self.qp, np.int32)
        self._qp_prev = self.qp
        self._dqp_pending = False
        n_ctu = self.nx * self.ny
        sao = _empty_sao(n_ctu) if self.sao_on else None
        for ci in range(n_ctu):
            cy, cx = divmod(ci, self.nx)
            if sao is not None:
                decode_sao_ctu(self.dec, self.ctx, sao, ci, cx, cy,
                               self.nx)
            self._dqp_pending = self.cu_qp_delta
            self.qp_ctb[cy, cx] = self._qp_prev
            self._coding_quadtree(cx * 64, cy * 64, 64, 0)
            term = self.dec.decode_terminate()
            require(term == (1 if ci == n_ctu - 1 else 0),
                    f"end_of_slice at CTU {ci}")
        return dict(depth8=self.depth8, mvq8=self.mvq8, ref8=self.ref8,
                    coef_y=self.coef_y, coef_cb=self.coef_cb,
                    coef_cr=self.coef_cr, sao=sao,
                    intra8=self.intra8, imodes4=self.imodes4,
                    part8=self.part8,
                    qp_ctb=self.qp_ctb if self.cu_qp_delta else None)

    def _coding_quadtree(self, x0, y0, size, depth):
        inside = (x0 + size <= self.W) and (y0 + size <= self.H)
        if inside and size > 8:
            inc = 0
            if x0 > 0:
                inc += int(self.depth8[y0 >> 3, (x0 - 1) >> 3] > depth)
            if y0 > 0:
                inc += int(self.depth8[(y0 - 1) >> 3, x0 >> 3] > depth)
            split = self.dec.decode_bin(self.ctx,
                                        self.ctx.idx("split_cu", inc))
        else:
            split = 1 if (not inside and size > 8) else 0
        if split:
            h = size >> 1
            for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < self.W and y1 < self.H:
                    self._coding_quadtree(x1, y1, h, depth + 1)
        else:
            self.depth8[y0 >> 3:(y0 + size) >> 3,
                        x0 >> 3:(x0 + size) >> 3] = depth
            self._coding_unit(x0, y0, size)

    def _read_eg1(self) -> int:
        count = 1
        v = 0
        while self.dec.decode_bypass():
            v += 1 << count
            count += 1
        return v + self.dec.decode_bypass_bins(count)

    def _read_merge_idx(self) -> int:
        if not self.dec.decode_bin(self.ctx, self.ctx.idx("merge_idx")):
            return 0
        idx = 1
        while idx < 4 and self.dec.decode_bypass():
            idx += 1
        return idx

    def _merge_motion(self, cands, idx):
        mot = cands[idx]
        if len(mot) != 3:
            raise NotImplementedError(
                f"merge_idx {idx} selects a bi-predictive zero candidate "
                "(8.5.3.2.5): bi-prediction is outside the decoder's "
                "uni-L0 toolset")
        return mot

    def _read_inter_pred_idc(self, size):
        """inter_pred_idc of a B-slice AMVP PU: only PRED_L0 is in the
        toolset (bin0 'bi?' at ctx CtDepth, bin1 'L1?' at ctx 4)."""
        dec, ctx = self.dec, self.ctx
        depth = 6 - (size.bit_length() - 1)
        if dec.decode_bin(ctx, ctx.idx("inter_dir", depth)):
            raise NotImplementedError(
                "PRED_BI PU: bi-prediction is outside the decoder's "
                "uni-L0 toolset")
        if dec.decode_bin(ctx, ctx.idx("inter_dir", 4)):
            raise NotImplementedError(
                "PRED_L1 PU: L1 motion is outside the decoder's uni-L0 "
                "toolset")

    def _set_mv(self, x0, y0, size, mot):
        self.mvq8[y0 >> 3:(y0 + size) >> 3,
                  x0 >> 3:(x0 + size) >> 3] = mot[:2]
        self.ref8[y0 >> 3:(y0 + size) >> 3,
                  x0 >> 3:(x0 + size) >> 3] = mot[2]

    def _read_ref_idx(self) -> int:
        """ref_idx_l0: TU cMax = n_refs-1; bin0/bin1 context-coded,
        rest bypass."""
        dec, ctx = self.dec, self.ctx
        if self.n_refs == 1 or not dec.decode_bin(ctx,
                                                  ctx.idx("ref_pic", 0)):
            return 0
        ref = 1
        cmax = self.n_refs - 2
        for i in range(cmax):
            bit = (dec.decode_bin(ctx, ctx.idx("ref_pic", 1)) if i == 0
                   else dec.decode_bypass())
            if not bit:
                break
            ref += 1
        return ref

    def _coding_unit(self, x0, y0, size):
        dec, ctx = self.dec, self.ctx
        inc = 0
        if x0 > 0:
            inc += int(self.skip8[y0 >> 3, (x0 - 1) >> 3])
        if y0 > 0:
            inc += int(self.skip8[(y0 - 1) >> 3, x0 >> 3])
        skip = dec.decode_bin(ctx, ctx.idx("skip_flag", inc))
        cands = motion.merge_candidates(self.field, x0, y0, size,
                                        self.n_refs, is_b=self.is_b)
        if skip:
            idx = self._read_merge_idx()
            self._set_mv(x0, y0, size, self._merge_motion(cands, idx))
            self.skip8[y0 >> 3:(y0 + size) >> 3,
                       x0 >> 3:(x0 + size) >> 3] = 1
            return
        pred_mode = dec.decode_bin(ctx, ctx.idx("pred_mode"))
        if pred_mode == 1:
            self._intra_coding_unit(x0, y0, size)
            return
        part = dec.decode_bin(ctx, ctx.idx("part_mode", 0))
        if part == 0:
            # rectangular PUs: '01' = 2NxN, '00' = Nx2N (amp off)
            two_nxn = dec.decode_bin(ctx, ctx.idx("part_mode", 1))
            self._rect_coding_unit(x0, y0, size, 1 if two_nxn else 2)
            return
        if dec.decode_bin(ctx, ctx.idx("merge_flag")):
            idx = self._read_merge_idx()
            self._set_mv(x0, y0, size, self._merge_motion(cands, idx))
            # rqt_root_cbf inferred 1 (7.3.8.5, 2Nx2N merge)
            self._transform_tree(x0, y0, size)
            return
        if self.is_b:
            self._read_inter_pred_idc(size)
        ref = self._read_ref_idx()
        has_x = dec.decode_bin(ctx, ctx.idx("mvd", 0))
        has_y = dec.decode_bin(ctx, ctx.idx("mvd", 0))
        gt1_x = dec.decode_bin(ctx, ctx.idx("mvd", 1)) if has_x else 0
        gt1_y = dec.decode_bin(ctx, ctx.idx("mvd", 1)) if has_y else 0
        mvd_x = mvd_y = 0
        if has_x:
            ax = 2 + self._read_eg1() if gt1_x else 1
            mvd_x = -ax if dec.decode_bypass() else ax
        if has_y:
            ay = 2 + self._read_eg1() if gt1_y else 1
            mvd_y = -ay if dec.decode_bypass() else ay
        mvp_idx = dec.decode_bin(ctx, ctx.idx("mvp_idx"))
        mvp = motion.amvp_candidates(self.field, x0, y0, size, size,
                                     ref, self.ref_pocs, self.poc)[mvp_idx]
        self._set_mv(x0, y0, size,
                     (mvp[0] + mvd_x, mvp[1] + mvd_y, ref))
        root_cbf = dec.decode_bin(ctx, ctx.idx("qt_root_cbf"))
        if root_cbf:
            self._transform_tree(x0, y0, size)

    def _rect_coding_unit(self, x0, y0, size, part):
        """Two rectangular PUs: per-PU merge-or-AMVP, rqt_root_cbf,
        inferred TU split."""
        dec, ctx = self.dec, self.ctx
        self.part8[y0 >> 3:(y0 + size) >> 3,
                   x0 >> 3:(x0 + size) >> 3] = part
        h = size >> 1
        pus = ([(x0, y0, size, h), (x0, y0 + h, size, h)] if part == 1
               else [(x0, y0, h, size), (x0 + h, y0, h, size)])
        for pidx, (xp, yp, wp, hp) in enumerate(pus):
            if dec.decode_bin(ctx, ctx.idx("merge_flag")):
                idx = self._read_merge_idx()
                cands = motion.merge_candidates(
                    self.field, xp, yp, size, self.n_refs, w=wp, h=hp,
                    part_mode=part, part_idx=pidx, is_b=self.is_b)
                mot = self._merge_motion(cands, idx)
            else:
                if self.is_b:
                    self._read_inter_pred_idc(size)
                ref = self._read_ref_idx()
                has_x = dec.decode_bin(ctx, ctx.idx("mvd", 0))
                has_y = dec.decode_bin(ctx, ctx.idx("mvd", 0))
                gt1_x = (dec.decode_bin(ctx, ctx.idx("mvd", 1))
                         if has_x else 0)
                gt1_y = (dec.decode_bin(ctx, ctx.idx("mvd", 1))
                         if has_y else 0)
                mvd_x = mvd_y = 0
                if has_x:
                    ax = 2 + self._read_eg1() if gt1_x else 1
                    mvd_x = -ax if dec.decode_bypass() else ax
                if has_y:
                    ay = 2 + self._read_eg1() if gt1_y else 1
                    mvd_y = -ay if dec.decode_bypass() else ay
                mvp_idx = dec.decode_bin(ctx, ctx.idx("mvp_idx"))
                mvp = motion.amvp_candidates(
                    self.field, xp, yp, wp, hp, ref, self.ref_pocs,
                    self.poc, cu_size=size, part_mode=part,
                    part_idx=pidx)[mvp_idx]
                mot = (mvp[0] + mvd_x, mvp[1] + mvd_y, ref)
            self.mvq8[yp >> 3:(yp + hp) >> 3,
                      xp >> 3:(xp + wp) >> 3] = mot[:2]
            self.ref8[yp >> 3:(yp + hp) >> 3,
                      xp >> 3:(xp + wp) >> 3] = mot[2]
        root_cbf = dec.decode_bin(ctx, ctx.idx("qt_root_cbf"))
        if root_cbf:
            self._transform_tree(x0, y0, size, force_split=True)

    # ---- intra CU in a P/B slice ----------------------------------------
    def _mpm_for4_p(self, x, y):
        cand_a = DC if x == 0 else int(self.imodes4[y >> 2, (x - 1) >> 2])
        cand_b = DC
        if y > 0 and (y - 1) >> 6 == y >> 6:
            cand_b = int(self.imodes4[(y - 1) >> 2, x >> 2])
        return mpm_list(cand_a, cand_b)

    def _intra_coding_unit(self, x0, y0, size):
        dec, ctx = self.dec, self.ctx
        if size == 8:
            part = dec.decode_bin(ctx, ctx.idx("part_mode", 0))
            require(part == 1, "intra NxN in P slices not in toolset")
        in_mpm = dec.decode_bin(ctx, ctx.idx("prev_intra_luma_pred"))
        mpm = self._mpm_for4_p(x0, y0)
        if in_mpm:
            idx = 0
            if dec.decode_bypass():
                idx = 1 + dec.decode_bypass()
            mode = mpm[idx]
        else:
            rem = dec.decode_bypass_bins(5)
            for m in sorted(mpm):
                if rem >= m:
                    rem += 1
            mode = rem
        dm = dec.decode_bin(ctx, ctx.idx("chroma_pred_mode"))
        require(dm == 0, "non-DM chroma modes not in toolset")
        s8 = slice(y0 >> 3, (y0 + size) >> 3), slice(x0 >> 3,
                                                     (x0 + size) >> 3)
        self.intra8[s8] = True
        self.inter8[s8] = False
        self.imodes4[y0 >> 2:(y0 + size) >> 2,
                     x0 >> 2:(x0 + size) >> 2] = mode
        self._intra_transform_tree(x0, y0, size, 0, mode)

    def _intra_transform_tree(self, x0, y0, size, trafo_depth, mode):
        dec, ctx = self.dec, self.ctx
        split = size > 32
        log2 = size.bit_length() - 1
        cbf_cb = cbf_cr = 0
        if log2 > 2:
            cbf_cb = dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma",
                                                 trafo_depth))
            cbf_cr = dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma",
                                                 trafo_depth))
        if split:
            h = size >> 1
            for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):
                x1, y1 = x0 + dx, y0 + dy
                ccb = (dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma",
                                                   trafo_depth + 1))
                       if cbf_cb else 0)
                ccr = (dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma",
                                                   trafo_depth + 1))
                       if cbf_cr else 0)
                cl = dec.decode_bin(ctx, ctx.idx("qt_cbf_luma", 0))
                self._intra_transform_unit(x1, y1, h, cl, ccb, ccr, mode)
            return
        cl = dec.decode_bin(
            ctx, ctx.idx("qt_cbf_luma", 1 if trafo_depth == 0 else 0))
        self._intra_transform_unit(x0, y0, size, cl, cbf_cb, cbf_cr, mode)

    def _intra_transform_unit(self, x0, y0, size, cl, ccb, ccr, mode):
        if cl or ccb or ccr:
            self._maybe_parse_dqp(x0, y0)
        if cl:
            st = scanlib.scan_type_for(mode, size, True)
            blk = residual.decode_residual(self.dec, self.ctx, size,
                                           is_luma=True, scan_type=st)
            self.coef_y[y0:y0 + size, x0:x0 + size] = blk
        half = size >> 1
        for (cbf, plane) in ((ccb, self.coef_cb), (ccr, self.coef_cr)):
            if cbf:
                st = scanlib.scan_type_for(mode, half, False)
                blk = residual.decode_residual(self.dec, self.ctx, half,
                                               is_luma=False,
                                               scan_type=st)
                plane[y0 >> 1:(y0 >> 1) + half,
                      x0 >> 1:(x0 >> 1) + half] = blk

    def _transform_tree(self, x0, y0, size, force_split=False):
        dec, ctx = self.dec, self.ctx
        cbf_cb = dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma", 0))
        cbf_cr = dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma", 0))
        if size > 32 or force_split:
            h = size >> 1
            for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):
                x1, y1 = x0 + dx, y0 + dy
                ccb = (dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma", 1))
                       if cbf_cb else 0)
                ccr = (dec.decode_bin(ctx, ctx.idx("qt_cbf_chroma", 1))
                       if cbf_cr else 0)
                cl = dec.decode_bin(ctx, ctx.idx("qt_cbf_luma", 0))
                self._transform_unit(x1, y1, h, cl, ccb, ccr)
        else:
            if cbf_cb or cbf_cr:
                cl = dec.decode_bin(ctx, ctx.idx("qt_cbf_luma", 1))
            else:
                cl = 1          # inferred (rqt_root_cbf was 1)
            self._transform_unit(x0, y0, size, cl, cbf_cb, cbf_cr)

    def _maybe_parse_dqp(self, x0, y0):
        """cu_qp_delta at the first coded TU of the CTB QG (7.3.8.12 /
        9.3.3): TR cMax 5 on ctx dqp[0]/dqp[1], EG0 bypass suffix,
        bypass sign."""
        if not self._dqp_pending:
            return
        self._dqp_pending = False
        dec, ctx = self.dec, self.ctx
        a = dec.decode_bin(ctx, ctx.idx("dqp", 0))
        if a:
            while a < 5 and dec.decode_bin(ctx, ctx.idx("dqp", 1)):
                a += 1
            if a == 5:
                k = 0                       # EG0 (xReadEpExGolomb)
                while dec.decode_bypass():
                    a += 1 << k
                    k += 1
                v = 0
                for _ in range(k):
                    v = (v << 1) | dec.decode_bypass()
                a += v
            if dec.decode_bypass():
                a = -a
        self._qp_prev = self._qp_prev + a
        self.qp_ctb[y0 >> 6, x0 >> 6] = self._qp_prev

    def _transform_unit(self, x0, y0, size, cl, ccb, ccr):
        if cl or ccb or ccr:
            self._maybe_parse_dqp(x0, y0)
        if cl:
            blk = residual.decode_residual(self.dec, self.ctx, size,
                                           is_luma=True,
                                           scan_type=scanlib.SCAN_DIAG)
            self.coef_y[y0:y0 + size, x0:x0 + size] = blk
        half = size >> 1
        if ccb:
            blk = residual.decode_residual(self.dec, self.ctx, half,
                                           is_luma=False,
                                           scan_type=scanlib.SCAN_DIAG)
            self.coef_cb[y0 >> 1:(y0 >> 1) + half,
                         x0 >> 1:(x0 >> 1) + half] = blk
        if ccr:
            blk = residual.decode_residual(self.dec, self.ctx, half,
                                           is_luma=False,
                                           scan_type=scanlib.SCAN_DIAG)
            self.coef_cr[y0 >> 1:(y0 >> 1) + half,
                         x0 >> 1:(x0 >> 1) + half] = blk
