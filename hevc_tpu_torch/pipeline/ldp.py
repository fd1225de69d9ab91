"""Low-Delay-P pipeline: pre-encode (residue) + ETH-CNN+LSTM prediction.

Reference flow (SURVEY.md 3.2): per P frame, a fast pre-encode with all
CUs/PUs forced to 64x64 produces an inter residue frame; the residue
feeds the ETH-CNN whose per-level FC1 vectors drive three ETH-LSTMs that
emit the HCPM for the real encode. The reference round-trips residue and
LSTM state through files (resi.yuv/state.dat, TEncGOP.cpp:1420-1524, and
the daemon resi_to_cu_depth_LDP.py); here both stay resident on the
device.

The pre-encode is a batched full integer-pel SAD search (+-8) followed
by a batched 49-candidate quarter-pel sweep per CTU using the normative
MC filters, referencing the previous frame; the residue is clipped to
uint8 around 128 exactly like the reference dump
(HM-16.5_Resi_Pre/TEncSearch.cpp:4550-4556).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.yuv import pad_frame
from ..models import eth_lstm, hcpm
from ..ops import inter
from . import search as search_lib


def _quarter_refine(cur_tiles, ref_plane, origins, mv_int):
    """Quarter-pel sweep: mv_q = 4*mv_int + (dx, dy), dx/dy in [-3, 3]."""
    return inter.quarter_refine_blocks(cur_tiles, ref_plane, origins,
                                       mv_int, 64)


def _tiles(plane, origins, size):
    """[B, size, size] tiles of a [H, W] plane at `origins` (x, y), rows
    and columns clamped to the plane."""
    return inter._gather_windows(plane, origins[:, 0], origins[:, 1],
                                 size, size)


def _motion(cur_tiles, ref_y, ref_cb, ref_cr, origins, stage_done=None):
    """The motion stages of one frame's forced-64x64 CTUs, shared by the
    pre-encode and the flat P-frame coder: integer search (+-8), the
    49-candidate quarter-pel sweep, then luma and chroma MC.

    cur_tiles: [B, 64, 64] int32; ref planes on the same device.
    stage_done, if given, is called with "integer_search" and
    "quarter_refine" as those stages end.
    Returns (mv_q [B, 2] int32, pred_y [B, 64, 64], pred_cb, pred_cr
    [B, 32, 32]).
    """
    done = stage_done or (lambda name: None)
    mv_int, _ = inter.integer_search_ctu(cur_tiles, ref_y, origins, radius=8)
    done("integer_search")
    mv_q, _ = _quarter_refine(cur_tiles, ref_y, origins, mv_int)
    done("quarter_refine")
    corg = origins // 2
    pred_y = inter.predict_inter_ctu(ref_y, origins, mv_q, is_luma=True)
    pred_cb = inter.predict_inter_ctu(ref_cb, corg, mv_q, is_luma=False)
    pred_cr = inter.predict_inter_ctu(ref_cr, corg, mv_q, is_luma=False)
    return mv_q, pred_y, pred_cb, pred_cr


def pre_encode(cur, ref, cur_cb, ref_cb, cur_cr, ref_cr, *, pad_w: int,
               pad_h: int, stage_done=None):
    """Forced-64x64 inter pre-encode of one frame. The planes are tensors
    on one device (any integer dtype).

    stage_done, if given, is called with each stage's name as the stage
    ends: "integer_search", "quarter_refine", "mc_residue".

    Returns (resi_y [B, 64, 64], resi_cb, resi_cr [B, 32, 32], int32 in
    u8 range, +128 centered; mv_q [B, 2] int32), on that device.
    """
    origins = torch.as_tensor(search_lib.ctu_grid(pad_w, pad_h),
                              device=cur.device)
    cur_tiles = _tiles(cur, origins, 64)
    mv_q, pred_y, pred_cb, pred_cr = _motion(cur_tiles, ref, ref_cb, ref_cr,
                                             origins, stage_done)
    corg = origins // 2
    resi_y = (cur_tiles - pred_y + 128).clamp_(0, 255)
    resi_cb = (_tiles(cur_cb, corg, 32) - pred_cb + 128).clamp_(0, 255)
    resi_cr = (_tiles(cur_cr, corg, 32) - pred_cr + 128).clamp_(0, 255)
    if stage_done is not None:
        stage_done("mc_residue")
    return resi_y, resi_cb, resi_cr, mv_q


def tiles_to_plane(tiles, pad_w, pad_h, size):
    """[B, s, s] raster CTU tiles -> [pad_h, pad_w] plane (numpy)."""
    if isinstance(tiles, torch.Tensor):
        return tiles_to_plane_t(tiles, pad_w, pad_h, size).cpu().numpy()
    nx = -(-pad_w // size)
    ny = -(-pad_h // size)
    t = np.asarray(tiles).reshape(ny, nx, size, size)
    plane = t.transpose(0, 2, 1, 3).reshape(ny * size, nx * size)
    return plane[:pad_h, :pad_w]


def tiles_to_plane_t(tiles, pad_w, pad_h, size):
    """`tiles_to_plane` on a tensor: the plane stays on its device."""
    nx = -(-pad_w // size)
    ny = -(-pad_h // size)
    t = tiles.reshape(ny, nx, size, size)
    plane = t.permute(0, 2, 1, 3).reshape(ny * size, nx * size)
    return plane[:pad_h, :pad_w]


class LDPPredictor:
    """Per-frame LDP HCPM prediction with resident LSTM state.

    Replaces the reference daemon (resi_to_cu_depth_LDP.py) and its
    file/poll protocol: call step(residue_tiles, poc) per P frame.
    lstm_params: the name -> array dict of an ETH-LSTM checkpoint.
    device=None means the card.
    """

    def __init__(self, cfg, lstm_params,
                 thresholds: Optional[hcpm.Thresholds] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = eth_lstm.EthLstm.from_numpy(lstm_params,
                                                 device=self.device)
        self.thr = thresholds or hcpm.DEFAULT_LDP
        self.state = eth_lstm.zero_state(cfg.ctus_x * cfg.ctus_y,
                                         device=self.device)

    def reset(self):
        self.state = torch.zeros_like(self.state)

    def step(self, resi_tiles, poc: int):
        """resi_tiles: [B, 64, 64] residue (128-centered) on the
        predictor's device. Returns [B, 21] HCPM probs there; the LSTM
        state advances in place."""
        B = resi_tiles.shape[0]
        qp = torch.full((B,), float(self.cfg.qp), dtype=torch.float32,
                        device=self.device)
        fig = torch.full((B,), poc % eth_lstm.GOP_LENGTH, dtype=torch.int64,
                         device=self.device)
        probs, self.state = eth_lstm.step(
            self.model, resi_tiles, qp, fig, self.state,
            thr_l1=self.thr.l1_lower, thr_l2=self.thr.l2_lower)
        return probs


class LDPPipeline:
    """Pre-encode + predict chain over a sequence (the reference's
    two-process per-frame lockstep, one program on the device). The
    reference of each P-frame is the previous original frame.
    device=None means the card."""

    def __init__(self, cfg, lstm_params=None, thresholds=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.predictor = (LDPPredictor(cfg, lstm_params, thresholds,
                                       device=self.device)
                          if lstm_params is not None else None)

    def _to_device(self, frame):
        """Pad on the host, one copy per plane, int32 on the device."""
        pf = pad_frame(frame, self.cfg.pad_width, self.cfg.pad_height)
        return [torch.as_tensor(p).to(self.device).to(torch.int32)
                for p in (pf.y, pf.cb, pf.cr)]

    def p_frame(self, cur, prev, poc: int, stage_done=None):
        """One P-frame on the device: cur and prev are (y, cb, cr) planes
        from `_to_device`. Returns (resi_y, resi_cb, resi_cr, mv_q, hcpm)
        as `pre_encode` and `LDPPredictor.step` give them (hcpm None
        without a model). stage_done as in `pre_encode`, and then with
        "lstm_step"."""
        cfg = self.cfg
        ry, rcb, rcr, mv = pre_encode(
            cur[0], prev[0], cur[1], prev[1], cur[2], prev[2],
            pad_w=cfg.pad_width, pad_h=cfg.pad_height, stage_done=stage_done)
        probs = None
        if self.predictor is not None:
            probs = self.predictor.step(ry, poc)
            if stage_done is not None:
                stage_done("lstm_step")
        return ry, rcb, rcr, mv, probs

    def run(self, frames):
        """Returns per-frame dicts: residue planes, MVs, HCPM (if model),
        as host NumPy arrays."""
        cfg = self.cfg
        out = []
        prev = None
        for poc, frame in enumerate(frames):
            cur = self._to_device(frame)
            rec = {"poc": poc}
            if poc > 0:
                ry, rcb, rcr, mv, probs = self.p_frame(cur, prev, poc)
                rec["resi_y"] = tiles_to_plane(ry, cfg.pad_width,
                                               cfg.pad_height, 64)
                rec["resi_cb"] = tiles_to_plane(rcb, cfg.pad_width // 2,
                                                cfg.pad_height // 2, 32)
                rec["resi_cr"] = tiles_to_plane(rcr, cfg.pad_width // 2,
                                                cfg.pad_height // 2, 32)
                rec["mv_q"] = mv.cpu().numpy()
                if probs is not None:
                    rec["hcpm"] = probs.cpu().numpy()
            out.append(rec)
            prev = cur
        return out
