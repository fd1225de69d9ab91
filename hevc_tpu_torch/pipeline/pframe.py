"""P-frame coding: motion search + MC + residual transform + recon on the
device, then the P-slice CABAC on the host.

`tree="full"` (the default, as in the reference): the HCPM-gated CU-tree
P search (pipeline/psearch: quadtree ME, AMVP, merge/skip, rectangular
PUs and intra-in-P) against the `cfg.num_refs` newest reconstructions,
gated by the ETH-LSTM when `lstm_params` is given (pre-encode residue
against the previous reconstruction -> HCPM, state on the device); intra
CUs are then re-coded normatively on the host (pipeline/intra_p).
`tree="flat"`: every CTU is one inter 2Nx2N 64x64 CU against the
previous reconstruction (the reference pre-encode shape,
HM-16.5_Resi_Pre/TEncCu.cpp:388-397), the fastest operating point; it
references the previous picture only, whatever `cfg.num_refs` says, as
the reference's flat tree does. Both trees take a picture-level rate
controller. The full tree also codes low-delay B (`slice_mode="B"`):
the same search and reconstruction, B slice headers and B-context slice
data (the flat tree refuses B). A per-CTU QP is not ported yet and
raises.

Inter reconstruction has no spatial dependency, so a whole frame runs as
one batch of CTU tiles; only the levels, the decision maps and the final
reconstruction go to the host (for the coder and the hash SEI). The
reference pictures stay on the device.
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
from ..ops import deblock, quant, sao
from . import golden, intra_p, ldp, psearch
from . import search as search_lib
from .ai import AIEncoder


def _qp_lambda(qp: int) -> float:
    """The flat tree's RDOQ lambda of a QP (float64, as the reference
    computes it from a static QP)."""
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


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

    lam, lam_c = _qp_lambda(qp), _qp_lambda(cqp)
    lvl_y, rr_y = psearch._tu_transform(cur_y_t - pred_y, qp, 32, lam, True)
    lvl_cb, rr_cb = psearch._tu_transform(
        ldp._tiles(cur_cb, corg, 32) - pred_cb, cqp, 16, lam_c, True,
        is_luma=False)
    lvl_cr, rr_cr = psearch._tu_transform(
        ldp._tiles(cur_cr, corg, 32) - pred_cr, cqp, 16, lam_c, True,
        is_luma=False)
    rec = [(p + r).clamp_(0, 255).to(torch.uint8)
           for p, r in ((pred_y, rr_y), (pred_cb, rr_cb), (pred_cr, rr_cr))]
    out = (lvl_y.to(torch.int16), lvl_cb.to(torch.int16),
           lvl_cr.to(torch.int16), *rec, mv_q)
    if stage_done is not None:
        stage_done("transform")
    return out


class LDPEncoder:
    """Low-delay sequence encoder: an IDR, then P (or, with
    `slice_mode="B"`, low-delay B) frames against earlier
    reconstructions, with the GOP-4 per-frame QP offsets of the
    reference encoder_lowdelay_P_main.cfg (or the QPs of a rate
    controller, `encode(rate_control=)`).

    tree="full" (the default, as in the reference) runs the CU-tree P
    search (pipeline/psearch) against the `cfg.num_refs` newest
    reconstructions (RefPicList0, newest first), with rectangular PUs
    unless `rect_pu=False`. With `lstm_params` (an ETH-LSTM checkpoint's
    name -> array dict) each P-frame is first pre-encoded against the
    previous reconstruction and the LSTM's HCPM gates the search
    (`thresholds`, default hcpm.DEFAULT_LDP); `max_depth_exit` narrows a
    frame's search to the deepest level a gate leaves open.
    tree="flat": one inter 2Nx2N 64x64 CU per CTU against the previous
    reconstruction, the P slices' RDOQ always on, whatever `cfg.rdoq`
    says, as in the reference. `slice_mode="B"` (full tree only) codes
    the same decisions as low-delay B slices: both lists hold the same
    pictures, every PU is uni-L0, and a PU whose motion only a
    bi-predictive zero merge candidate would give is coded by AMVP.
    `cfg.cu_qp_delta` raises.

    cnn: an `eth_cnn.EthCnn` for the IDR's decide, or None for the
    ungated search. device=None means the card; with no card that raises
    (pass device="cpu" to run on the CPU).
    """

    def __init__(self, cfg, cnn=None, lstm_params=None, thresholds=None,
                 tree: str = "full", use_gop_qp: bool = True,
                 slice_mode: str = "P", max_depth_exit: bool = False,
                 rect_pu: bool = True, device=None):
        if tree not in ("full", "flat"):
            raise ValueError(f"tree={tree!r}: 'full' or 'flat'")
        if slice_mode not in ("P", "B"):
            raise ValueError(f"slice_mode={slice_mode!r}: 'P' or 'B'")
        if slice_mode == "B" and tree == "flat":
            # the reference's flat tree writes a P slice header and codes
            # its data with B contexts: HM reports an MD5 mismatch
            raise NotImplementedError(
                "slice_mode='B' with tree='flat': the flat tree codes P "
                "slices only; low-delay B runs on tree='full'")
        if getattr(cfg, "cu_qp_delta", False):
            raise NotImplementedError(
                "cu_qp_delta: a per-CTU QP is not ported yet (ROADMAP "
                "Queue 1, M11)")
        if cfg.pad_width % 64 or cfg.pad_height % 64:
            # LDP codes whole CTUs only; pad to 64-multiples and crop via
            # the SPS conformance window
            cfg = dataclasses.replace(cfg, pad_align=64)
        self.cfg = cfg
        self.tree = tree
        self.rect_pu = rect_pu
        self.use_gop_qp = use_gop_qp
        self.slice_mode = slice_mode
        self.last_stats = {}
        self.device = resolve_device(device)
        self.intra = AIEncoder(cfg, cnn=cnn, device=self.device)
        self.predictor = (ldp.LDPPredictor(cfg, lstm_params, thresholds,
                                           device=self.device)
                          if lstm_params is not None else None)
        self.max_depth_exit = max_depth_exit and self.predictor is not None
        self._origins = torch.as_tensor(
            search_lib.ctu_grid(cfg.pad_width, cfg.pad_height),
            dtype=torch.int64, device=self.device)

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

    def encode(self, frames, with_hash_sei: bool = True,
               rate_control=None):
        """Encode a sequence; returns (annexb bytes, recons).
        rate_control: an optional pipeline/ratectrl.RateController; it
        picks every picture's QP (the IDR's too, no GOP offsets) and is
        given each picture's bits, its hash SEI left out.
        `last_stats` then holds decide_s (the IDR's decide; the P frames'
        pre-encode, LSTM step and search, or the flat tree's motion
        stages), recon_s (the IDR's reconstruction; the P frames'
        transforms or the intra re-code, filters and copies to the host),
        entropy_s (the coders and the hash SEI); `frame_s` each picture's
        wall seconds."""
        if hasattr(rate_control, "pre_frame_lcu"):
            raise NotImplementedError(
                "LCU rate control: a per-CTU QP is not ported yet "
                "(ROADMAP Queue 1, M11)")
        cfg = self.cfg
        chunks = [headers.write_vps(cfg), headers.write_sps(cfg),
                  headers.write_pps(cfg)]
        recons = []
        dpb = []                  # padded device reconstructions, newest first
        stats = {"decide_s": 0.0, "recon_s": 0.0, "entropy_s": 0.0}
        self.last_stats = stats
        self.frame_s = []
        self.frame_qps = []       # actual per-picture QPs
        if self.predictor is not None:
            self.predictor.reset()
        for poc, frame in enumerate(frames):
            t_frame = time.perf_counter()
            pf = pad_frame(frame, cfg.pad_width, cfg.pad_height)
            frame_qp = (rate_control.pre_frame() if rate_control
                        else self._frame_qp(poc))
            self.frame_qps.append(frame_qp)
            n_chunks0 = len(chunks)
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
                if self.tree == "flat":
                    rec, ref, chunk = self._encode_flat(pf, dpb[0], poc,
                                                        frame_qp, times)
                else:
                    rec, ref, chunk = self._encode_full(pf, tuple(dpb), poc,
                                                        frame_qp, times)
                chunks.append(chunk)
                stats["decide_s"] += times["decide_s"]
                stats["recon_s"] += times["recon_s"]
                t_entropy = times["entropy_s"]
            t0 = time.perf_counter()
            if rate_control:
                rate_control.post_frame(
                    8 * sum(len(c) for c in chunks[n_chunks0:]))
            if with_hash_sei:
                tid, hs = golden.pic_hashes(rec, cfg.hash_type)
                chunks.append(headers.write_hash_sei(*hs, hash_type=tid))
            stats["entropy_s"] += t_entropy + time.perf_counter() - t0
            # returned recon = decoder-output view (conformance-cropped);
            # referencing and the hash SEI use the full padded picture
            recons.append(crop_frame(rec, cfg.width, cfg.height))
            dpb.insert(0, ref)
            del dpb[max(cfg.num_refs, 1):]
            self.frame_s.append(time.perf_counter() - t_frame)
        return b"".join(chunks), recons

    def _p_slice_nal(self, bw, depth8, mvq8, coef_y, coef_cb, coef_cr,
                     frame_qp, sao_params=None, **kw):
        """P or B slice NAL: header bits in `bw`, then the slice data of
        the native C++ coder (kw: its ref8, n_refs, poc, intra8, imode8,
        part8). A failure of the coder raises: there is no fallback
        coder."""
        cfg = self.cfg
        data = native.encode_slice_data_p(
            depth8, mvq8, coef_y, coef_cb, coef_cr, cfg.pad_width,
            cfg.pad_height, frame_qp, is_b=self.slice_mode == "B",
            sao=sao_params, **kw)
        return nal_unit(NAL_TRAIL_R, bw.get_bytes() + data)

    def _encode_full(self, pf, dpb, poc, frame_qp, times=None):
        """One CU-tree P frame. pf: the padded host Frame; dpb: the
        reference pictures, newest first, each as (y, cb, cr) int32
        planes on the device. Returns (padded reconstruction as a host
        Frame, the same as int32 device planes for the DPB, NAL bytes).
        times, if given, receives predict_s (pre-encode and LSTM step),
        search_s, decide_s (their sum), recon_s (`finish_p_frame` but the
        coder) and entropy_s."""
        cfg = self.cfg
        W, H = cfg.pad_width, cfg.pad_height
        marks = [time.perf_counter()]
        cur = self._upload(pf)
        prev = dpb[0]
        probs, gate = None, {}
        if self.predictor is not None:
            # the pre-encode against the previous reconstruction
            ry, _, _, _ = ldp.pre_encode(cur[0], prev[0], cur[1], prev[1],
                                         cur[2], prev[2], pad_w=W, pad_h=H)
            probs = self.predictor.step(ry, poc)
            thr = self.predictor.thr
            gate = dict(hcpm_probs=probs, thr_up=thr.up, thr_down=thr.down)
        self._sync()
        marks.append(time.perf_counter())
        max_depth = 3
        if self.max_depth_exit:
            max_depth = search_lib.gate_max_depth(probs, self.predictor.thr,
                                                  W, H)
        n_act = min(poc, cfg.num_refs)
        # RefPicList0 as [R, H, W] stacks of cfg.num_refs pictures, padded
        # by repeating the oldest; the search selects the n_act first
        refs = (list(dpb) + [dpb[-1]] * cfg.num_refs)[:cfg.num_refs]
        res = psearch.p_search_frame(
            *cur, *(torch.stack([r[c] for r in refs]) for c in range(3)),
            self._origins, qp=frame_qp, pad_w=W, pad_h=H, use_rdoq=cfg.rdoq,
            n_active_refs=n_act, max_depth=max_depth, rect_pu=self.rect_pu,
            **gate)
        self._sync()
        marks.append(time.perf_counter())
        rec, ref, chunk = self.finish_p_frame(pf, cur, res, poc, frame_qp,
                                              n_act, marks)
        if times is not None:
            times.update(predict_s=marks[1] - marks[0],
                         search_s=marks[2] - marks[1],
                         decide_s=marks[2] - marks[0],
                         recon_s=marks[3] - marks[2],
                         entropy_s=marks[4] - marks[3])
        return rec, ref, chunk

    def finish_p_frame(self, pf, cur, res, poc, frame_qp, n_act,
                       marks=None):
        """The finish of one searched P frame: tiles to planes, the
        normative re-code of intra CUs (host, z-order), the loop filters
        and the slice NAL. pf: the padded host Frame; cur: its planes on
        the device; res: the `psearch.PSearchResult`. Returns (padded
        reconstruction as a host Frame, the same as int32 device planes,
        NAL bytes). marks, if given, gets the time when the coder starts
        and when it ends."""
        cfg = self.cfg
        W, H = cfg.pad_width, cfg.pad_height

        def plane(t, size):
            return ldp.tiles_to_plane_t(t, W * size // 64, H * size // 64,
                                        size)

        rec = [plane(res.rec_y, 64), plane(res.rec_cb, 32),
               plane(res.rec_cr, 32)]
        coef = [plane(res.coef_y, 64), plane(res.coef_cb, 32),
                plane(res.coef_cr, 32)]
        maps = {k: plane(getattr(res, k), 8)
                for k in ("depth8", "ref8", "intra8", "imode8", "part8")}
        maps["mvq8"] = torch.stack([plane(res.mv8[..., 0], 8),
                                    plane(res.mv8[..., 1], 8)], -1)
        host = {k: v.cpu().numpy() for k, v in maps.items()}
        coef_h = [c.to(torch.int32).cpu().numpy() for c in coef]
        # None where every CU is 2Nx2N, as the reference passes it
        part8 = maps["part8"] if host["part8"].any() else None
        intra8 = None
        if host["intra8"].any():
            # normative re-code of intra CUs from reconstructed
            # neighbours, patching the recon and level planes in z-order
            intra8 = maps["intra8"]
            rec_h = [p.to(torch.int32).cpu().numpy() for p in rec]
            intra_p.patch_intra_cus(
                pf.y, pf.cb, pf.cr, *rec_h, *coef_h, host["depth8"],
                host["intra8"], host["imode8"], frame_qp, W, H,
                rdoq=cfg.rdoq)
            rec = [torch.as_tensor(p).to(self.device) for p in rec_h]
            coef[0] = torch.as_tensor(coef_h[0]).to(self.device)
        sao_params = None
        if cfg.deblock:
            rec = deblock.deblock_frame_inter(
                *rec, maps["depth8"], maps["mvq8"], coef[0], frame_qp,
                ref8=maps["ref8"], intra8=intra8, part8=part8)
        if cfg.sao:
            sao_params = sao.estimate_frame(*cur, *rec, frame_qp)
            rec = sao.apply_frame(*rec, sao_params)
        ref = tuple(p.to(torch.int32) for p in rec)
        out = Frame(*(p.to(torch.uint8).cpu().numpy() for p in rec))
        if marks is not None:
            marks.append(time.perf_counter())
        start = (headers.start_b_slice if self.slice_mode == "B"
                 else headers.start_p_slice)
        bw = start(cfg, frame_qp, poc, n_act)
        chunk = self._p_slice_nal(
            bw, host["depth8"], host["mvq8"], *coef_h, frame_qp, sao_params,
            ref8=host["ref8"], n_refs=n_act, poc=poc,
            intra8=host["intra8"] if intra8 is not None else None,
            imode8=host["imode8"],
            part8=host["part8"] if part8 is not None else None)
        if marks is not None:
            marks.append(time.perf_counter())
        return out, ref, chunk

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
