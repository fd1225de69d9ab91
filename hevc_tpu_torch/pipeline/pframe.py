"""P-frame coding: motion search + MC + residual transform + recon on the
device, then the P-slice CABAC on the host.

`tree="flat"`: every CTU is one inter 2Nx2N 64x64 CU against the previous
reconstruction (the reference pre-encode shape,
HM-16.5_Resi_Pre/TEncCu.cpp:388-397), the fastest operating point. It
references the previous picture only, whatever `cfg.num_refs` says, as
the reference's flat tree does. The full CU-tree search (`tree="full"`)
and low-delay B are not ported yet and raise.

Inter reconstruction has no spatial dependency, so a whole frame runs as
one batch of CTU tiles; only the levels, the MVs and the final
reconstruction go to the host (for the coder and the hash SEI). The
reference picture stays on the device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import native, resolve_device
from ..core.yuv import Frame, crop_frame, pad_frame
from ..entropy import headers
from ..entropy.bitstream import NAL_TRAIL_R, nal_unit
from ..ops import deblock, quant, sao, transforms
from ..ops import rdoq as rdoq_lib
from . import golden, ldp
from . import search as search_lib
from .ai import AIEncoder


def _tile_tu_transform(tiles, qp, tu: int, rdoq=True, is_luma=True):
    """[B, S, S] residual tiles -> (levels, recon_resi) per TU of size tu.
    The lambda comes from the QP given (the chroma QP for chroma)."""
    B, S, _ = tiles.shape
    g = S // tu
    t = tiles.reshape(B, g, tu, g, tu).permute(0, 1, 3, 2, 4)
    t = t.reshape(B * g * g, tu, tu)
    cf = transforms.forward_transform(t)
    if rdoq:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        lvl = rdoq_lib.rd_quantize(cf, qp, lam, is_intra=False,
                                   is_luma=is_luma)
    else:
        lvl = quant.quantize(cf, qp, is_intra=False)
    rr = transforms.inverse_transform(quant.dequantize(lvl, qp))

    def back(x):
        x = x.reshape(B, g, g, tu, tu).permute(0, 1, 3, 2, 4)
        return x.reshape(B, S, S)

    return back(lvl), back(rr)


def encode_p_frame_device(cur_y, cur_cb, cur_cr, ref_y, ref_cb, ref_cr, *,
                          qp: int, pad_w: int, pad_h: int, stage_done=None):
    """P-frame coding of padded int32 planes against the reconstructed
    reference, on the planes' device; nothing is copied to the host.

    stage_done, if given, is called with "integer_search",
    "quarter_refine", "motion_compensation" and "transform" (residual
    transform, quantization, reconstruction) as those stages end.
    Returns (levels y/cb/cr int16 tiles, recon y/cb/cr uint8 tiles,
    mv_q [B, 2] int32)."""
    origins = torch.as_tensor(search_lib.ctu_grid(pad_w, pad_h),
                              device=cur_y.device)
    corg = origins // 2
    cqp = quant.chroma_qp(qp)
    cur_y_t = ldp._tiles(cur_y, origins, 64)
    mv_q, pred_y, pred_cb, pred_cr = ldp._motion(
        cur_y_t, ref_y, ref_cb, ref_cr, origins, stage_done)
    if stage_done is not None:
        stage_done("motion_compensation")

    lvl_y, rr_y = _tile_tu_transform(cur_y_t - pred_y, qp, 32)
    lvl_cb, rr_cb = _tile_tu_transform(ldp._tiles(cur_cb, corg, 32) - pred_cb,
                                       cqp, 16, is_luma=False)
    lvl_cr, rr_cr = _tile_tu_transform(ldp._tiles(cur_cr, corg, 32) - pred_cr,
                                       cqp, 16, is_luma=False)
    rec = [(p + r).clamp_(0, 255).to(torch.uint8)
           for p, r in ((pred_y, rr_y), (pred_cb, rr_cb), (pred_cr, rr_cr))]
    out = (lvl_y.to(torch.int16), lvl_cb.to(torch.int16),
           lvl_cr.to(torch.int16), *rec, mv_q)
    if stage_done is not None:
        stage_done("transform")
    return out


class LDPEncoder:
    """Low-Delay-P sequence encoder: an IDR, then P frames against the
    previous reconstruction, with the GOP-4 per-frame QP offsets of the
    reference encoder_lowdelay_P_main.cfg.

    Ported: `tree="flat"` (one inter 2Nx2N 64x64 CU per CTU, the P
    slices' RDOQ always on, whatever `cfg.rdoq` says, as in the
    reference) with `slice_mode="P"`. `tree="full"` (the HCPM-gated
    quadtree search) and `slice_mode="B"` raise. The default stays
    `tree="full"`, as in the reference.

    cnn: an `eth_cnn.EthCnn` for the IDR's decide, or None for the
    ungated search. device=None means the card; with no card that raises
    (pass device="cpu" to run on the CPU).
    """

    def __init__(self, cfg, cnn=None, tree: str = "full",
                 use_gop_qp: bool = True, slice_mode: str = "P",
                 device=None):
        if tree != "flat":
            raise NotImplementedError(
                f"tree={tree!r}: the CU-tree P search is not ported yet "
                "(ROADMAP Queue 1, M10b part 2); use tree='flat'")
        if slice_mode != "P":
            # the reference's flat tree writes a P slice header and codes
            # its data with B contexts: HM reports an MD5 mismatch
            raise NotImplementedError(
                f"slice_mode={slice_mode!r}: low-delay B is not ported yet "
                "(ROADMAP Queue 1, M10b part 4)")
        if getattr(cfg, "cu_qp_delta", False):
            raise NotImplementedError("per-CTU QP is not ported yet")
        if cfg.pad_width % 64 or cfg.pad_height % 64:
            # LDP codes whole CTUs only; pad to 64-multiples and crop via
            # the SPS conformance window
            cfg = dataclasses.replace(cfg, pad_align=64)
        self.cfg = cfg
        self.use_gop_qp = use_gop_qp
        self.device = resolve_device(device)
        self.intra = AIEncoder(cfg, cnn=cnn, device=self.device)

    def _frame_qp(self, poc: int) -> int:
        offsets = self.cfg.gop_qp_offsets
        if poc == 0 or not self.use_gop_qp or not offsets:
            return self.cfg.qp
        off = offsets[(poc - 1) % len(offsets)]
        return min(51, self.cfg.qp + off)

    def _upload(self, frame):
        """A padded host Frame as (y, cb, cr) int32 planes on the device."""
        return tuple(torch.as_tensor(p).to(self.device).to(torch.int32)
                     for p in (frame.y, frame.cb, frame.cr))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def encode(self, frames, with_hash_sei: bool = True):
        """Encode a sequence; returns (annexb bytes, recons, stats).
        stats: decide_s (the IDR's decide, the P frames' motion stages),
        recon_s (the IDR's reconstruction; the P frames' transform,
        quantization, reconstruction, filters and copies to the host),
        entropy_s (the coders and the hash SEI)."""
        cfg = self.cfg
        chunks = [headers.write_vps(cfg), headers.write_sps(cfg),
                  headers.write_pps(cfg)]
        recons = []
        dpb = []                  # padded device reconstructions, newest first
        stats = {"decide_s": 0.0, "recon_s": 0.0, "entropy_s": 0.0}
        self.frame_qps = []       # actual per-picture QPs
        for poc, frame in enumerate(frames):
            pf = pad_frame(frame, cfg.pad_width, cfg.pad_height)
            frame_qp = self._frame_qp(poc)
            self.frame_qps.append(frame_qp)
            if poc == 0:
                t0 = time.perf_counter()
                d8, m8, m4, nxn = self.intra.decide_frame_full(
                    pf.y, frame_qp, pf.cb, pf.cr)
                t1 = time.perf_counter()
                decisions, rec = self.intra.reconstruct(
                    pf, d8, m8, frame_qp, modes4=m4, nxn8=nxn)
                ref = self._upload(rec)
                t2 = time.perf_counter()
                chunks.append(self.intra._entropy_encode(decisions,
                                                         frame_qp))
                stats["decide_s"] += t1 - t0
                stats["recon_s"] += t2 - t1
                t_entropy = time.perf_counter() - t2
            else:
                times = {}
                rec, ref, chunk = self._encode_flat(pf, dpb[0], poc,
                                                    frame_qp, times)
                chunks.append(chunk)
                stats["decide_s"] += times["decide_s"]
                stats["recon_s"] += times["recon_s"]
                t_entropy = times["entropy_s"]
            t0 = time.perf_counter()
            if with_hash_sei:
                tid, hs = golden.pic_hashes(rec, cfg.hash_type)
                chunks.append(headers.write_hash_sei(*hs, hash_type=tid))
            stats["entropy_s"] += t_entropy + time.perf_counter() - t0
            # returned recon = decoder-output view (conformance-cropped);
            # referencing and the hash SEI use the full padded picture
            recons.append(crop_frame(rec, cfg.width, cfg.height))
            dpb.insert(0, ref)
            del dpb[max(cfg.num_refs, 1):]
        return b"".join(chunks), recons, stats

    def _p_slice_nal(self, bw, depth8, mvq8, coef_y, coef_cb, coef_cr,
                     frame_qp, sao_params=None):
        """P slice NAL: header bits in `bw`, then the slice data of the
        native C++ coder. A failure of the coder raises: there is no
        fallback coder."""
        cfg = self.cfg
        data = native.encode_slice_data_p(
            depth8, mvq8, coef_y, coef_cb, coef_cr, cfg.pad_width,
            cfg.pad_height, frame_qp, sao=sao_params)
        return nal_unit(NAL_TRAIL_R, bw.get_bytes() + data)

    def _encode_flat(self, pf, prev, poc, frame_qp, times=None):
        """One flat-tree P frame. pf: the padded host Frame; prev: the
        reference as (y, cb, cr) int32 planes on the device. Returns
        (padded reconstruction as a host Frame, the same as int32 device
        planes for the DPB, NAL bytes). times, if given, receives
        decide_s, recon_s and entropy_s."""
        cfg = self.cfg
        W, H = cfg.pad_width, cfg.pad_height
        marks = [time.perf_counter()]

        def motion_done(name):
            if name == "motion_compensation":
                self._sync()
                marks.append(time.perf_counter())

        cur = self._upload(pf)
        cy, ccb, ccr, ry, rcb, rcr, mvq = encode_p_frame_device(
            *cur, *prev, qp=frame_qp, pad_w=W, pad_h=H,
            stage_done=motion_done)
        rec_y = ldp.tiles_to_plane_t(ry, W, H, 64)
        rec_cb = ldp.tiles_to_plane_t(rcb, W // 2, H // 2, 32)
        rec_cr = ldp.tiles_to_plane_t(rcr, W // 2, H // 2, 32)
        coef_y = ldp.tiles_to_plane_t(cy, W, H, 64)
        nx = cfg.ctus_x
        depth8 = np.zeros((H // 8, W // 8), np.int32)
        sao_params = None
        if cfg.deblock or cfg.sao:
            if cfg.deblock:
                mvq8_t = (mvq.reshape(cfg.ctus_y, nx, 2)
                          .repeat_interleave(8, 0).repeat_interleave(8, 1))
                rec_y, rec_cb, rec_cr = deblock.deblock_frame_inter(
                    rec_y, rec_cb, rec_cr,
                    torch.zeros(depth8.shape, dtype=torch.int32,
                                device=self.device),
                    mvq8_t, coef_y, frame_qp)
            if cfg.sao:
                sao_params = sao.estimate_frame(*cur, rec_y, rec_cb, rec_cr,
                                                frame_qp)
                rec_y, rec_cb, rec_cr = sao.apply_frame(rec_y, rec_cb, rec_cr,
                                                        sao_params)
        ref = tuple(p.to(torch.int32) for p in (rec_y, rec_cb, rec_cr))
        # to the host: levels, MVs and the reconstruction (waits for the
        # device)
        rec = Frame(*(p.to(torch.uint8).cpu().numpy()
                      for p in (rec_y, rec_cb, rec_cr)))
        coef_y = coef_y.cpu().numpy()
        coef_cb = ldp.tiles_to_plane(ccb, W // 2, H // 2, 32)
        coef_cr = ldp.tiles_to_plane(ccr, W // 2, H // 2, 32)
        mvq = mvq.cpu().numpy()
        marks.append(time.perf_counter())
        # each CTU's MV over its 8x8 cells, CTUs in raster order
        mvq8 = np.repeat(np.repeat(mvq.reshape(cfg.ctus_y, nx, 2), 8, 0),
                         8, 1)[:H // 8, :W // 8]
        bw = headers.start_p_slice(cfg, frame_qp, poc)
        chunk = self._p_slice_nal(bw, depth8, mvq8, coef_y, coef_cb, coef_cr,
                                  frame_qp, sao_params)
        marks.append(time.perf_counter())
        if times is not None:
            times.update(decide_s=marks[1] - marks[0],
                         recon_s=marks[2] - marks[1],
                         entropy_s=marks[3] - marks[2])
        return rec, ref, chunk
