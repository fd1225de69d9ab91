"""All-Intra encoder pipeline: ETH-CNN HCPM -> search -> coding ->
in-loop filters -> CABAC.

The predictor, the partition search (with the 35-mode SATD kernel), the
normative wavefront reconstruction (pipeline/recon.py: the
reconstruction kernel on the card) and the optional deblocking and SAO
(ops/deblock.py, ops/sao.py) run on the device as tensors; the SAO
parameter decision and CABAC run on the host (native C++ coder).

Two other reconstruction backends, as in the reference: `"golden"`, the
sequential NumPy encoder on the host (pipeline/golden.py), and `"tu"`,
the TU-level wavefront in plain PyTorch on the device
(pipeline/recon_tu.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import native, resolve_device
from ..core.yuv import Frame, crop_frame, extract_ctus, pad_frame
from ..entropy import headers
from ..entropy.bitstream import NAL_IDR_W_RADL, nal_unit
from ..models import eth_cnn, hcpm
from ..ops import deblock, sao
from . import golden, recon, recon_tu, search

RECON_BACKENDS = ("auto", "golden", "tu")


class AIEncoder:
    def __init__(self, cfg: headers.EncoderConfig,
                 cnn: Optional[eth_cnn.EthCnn] = None,
                 thresholds: Optional[hcpm.Thresholds] = None,
                 max_depth_exit: bool = False, device=None,
                 recon_backend: str = "auto"):
        """cnn: an `eth_cnn.EthCnn` (e.g. `eth_cnn.load_npz(path)`), or
        None for the ungated full search. device=None means the card; with
        no card that raises (pass device="cpu" to run on the CPU).

        recon_backend: "auto" reconstructs through
        `recon.encode_frame_planes_batched` (the reconstruction kernel on
        CUDA tensors, its plain version on CPU tensors); "golden" through
        `golden.GoldenEncoder.encode_frame` on the host, at `cfg.qp` and
        without the filters, as the reference's golden backend codes — so
        it raises for deblocking, SAO or a rate controller; "tu" through
        `recon_tu.reconstruct_tu` on the device, which codes TU == CU, so
        NxN is turned off in the config (as the reference does); it keeps
        the filters and the frame's QP."""
        if getattr(cfg, "cu_qp_delta", False):
            raise NotImplementedError("per-CTU QP is not ported yet")
        if recon_backend not in RECON_BACKENDS:
            raise ValueError(f"unknown recon_backend {recon_backend!r}")
        if recon_backend == "golden" and (cfg.deblock or cfg.sao):
            raise NotImplementedError(
                'recon_backend="golden" runs no deblocking or SAO: the '
                "reference's golden backend returns before the filters "
                '(use "auto" or "tu" for filtered encodes)')
        if recon_backend == "tu" and cfg.nxn:
            cfg = dataclasses.replace(cfg, nxn=False)
        self.recon_backend = recon_backend
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cnn = cnn.to(self.device) if cnn is not None else None
        self.thr = thresholds or hcpm.DEFAULT_AI
        # Frame-level early exit: when the HCPM gates close every split
        # at some level frame-wide, run a narrower search that never
        # evaluates the deeper CU levels — the analogue of the reference's
        # per-CU RD-check skipping (TEncCu.cpp:862-873), realized as a
        # host decision.
        self.max_depth_exit = max_depth_exit and cnn is not None
        self._origins = torch.as_tensor(
            search.ctu_grid(cfg.pad_width, cfg.pad_height),
            dtype=torch.int64, device=self.device)

    def _t(self, a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def predict_hcpm(self, y_pad: np.ndarray, qp=None):
        """ETH-CNN inference over the frame's CTUs -> [B, 21] probs."""
        ctus = self._t(extract_ctus(y_pad))
        qpv = torch.full((ctus.shape[0],),
                         float(self.cfg.qp if qp is None else qp),
                         dtype=torch.float32, device=self.device)
        return eth_cnn.apply(self.cnn, ctus, qpv, thr_l1=self.thr.l1_lower,
                             thr_l2=self.thr.l2_lower)

    def decide_frame(self, y_pad: np.ndarray, qp=None, cb_pad=None,
                     cr_pad=None):
        """Run (CNN +) search; returns frame-level depth8/modes8 maps.
        cb_pad/cr_pad: optional chroma planes — tree decisions then
        include the chroma RD contribution."""
        d8, m8, _, _ = self.decide_frame_full(y_pad, qp, cb_pad, cr_pad)
        return d8, m8

    def decide_frame_full(self, y_pad: np.ndarray, qp=None, cb_pad=None,
                          cr_pad=None):
        """decide_frame + the NxN decisions: returns (depth8, modes8,
        modes4, nxn8) frame-level maps (host arrays)."""
        cfg = self.cfg
        qp = cfg.qp if qp is None else qp
        kw = dict(pad_w=cfg.pad_width, pad_h=cfg.pad_height,
                  n_ctu_x=cfg.ctus_x, qp=qp, nxn=cfg.nxn)
        if cb_pad is not None:
            kw.update(cb_plane=self._t(cb_pad), cr_plane=self._t(cr_pad))
        if self.cnn is not None:
            probs = self.predict_hcpm(y_pad, qp)
            md = (search.gate_max_depth(probs, self.thr, self.cfg.pad_width,
                                        self.cfg.pad_height)
                  if self.max_depth_exit else 3)
            kw.update(hcpm_probs=probs, thr_up=self.thr.up,
                      thr_down=self.thr.down, max_depth=md)
        res = search.search_frame(self._t(y_pad), self._origins, **kw)
        return self._assemble(res)

    def _assemble(self, res: search.SearchResult):
        cfg = self.cfg
        nx, ny = cfg.ctus_x, cfg.ctus_y

        def grid(t, u):
            a = t.cpu().numpy().reshape(ny, nx, u, u)
            a = a.transpose(0, 2, 1, 3).reshape(ny * u, nx * u)
            return a[:cfg.pad_height * u // 64, :cfg.pad_width * u // 64]

        d = grid(res.depth8, 8).astype(np.int32)
        m = grid(res.modes8, 8).astype(np.int32)
        m4 = grid(res.modes4, 16).astype(np.int32)
        nxn = grid(res.nxn8, 8).astype(bool)
        return d, m, m4, nxn

    def encode(self, frames, with_hash_sei: bool = True,
               rate_control=None):
        """Encode a sequence; returns (annexb bytes, recons, stats).
        rate_control: optional pipeline/ratectrl.RateController — picks
        a per-picture QP and is updated with actual bits."""
        if rate_control is not None and self.recon_backend == "golden":
            raise NotImplementedError(
                'recon_backend="golden" codes every picture at cfg.qp, as '
                "the reference's golden encoder does, so it takes no rate "
                'controller (use "auto" or "tu")')
        cfg = self.cfg
        chunks = [headers.write_vps(cfg), headers.write_sps(cfg),
                  headers.write_pps(cfg)]
        recons = []
        stats = {"decide_s": 0.0, "recon_s": 0.0, "entropy_s": 0.0}
        self.frame_qps = []  # actual per-picture QPs
        for frame in frames:
            pf = pad_frame(frame, cfg.pad_width, cfg.pad_height)
            qp = rate_control.pre_frame() if rate_control else cfg.qp
            self.frame_qps.append(qp)
            t0 = time.perf_counter()
            depth8, modes8, modes4, nxn8 = self.decide_frame_full(
                pf.y, qp, pf.cb, pf.cr)
            t1 = time.perf_counter()
            decisions, rec = self.reconstruct(pf, depth8, modes8, qp,
                                              modes4=modes4, nxn8=nxn8)
            t2 = time.perf_counter()
            chunks.append(self._entropy_encode(decisions, qp))
            if rate_control:
                rate_control.post_frame(8 * len(chunks[-1]))
            if with_hash_sei:
                tid, hs = golden.pic_hashes(rec, cfg.hash_type)
                chunks.append(headers.write_hash_sei(*hs, hash_type=tid))
            t3 = time.perf_counter()
            stats["decide_s"] += t1 - t0
            stats["recon_s"] += t2 - t1
            stats["entropy_s"] += t3 - t2
            # returned recon = decoder-output view (conformance-cropped);
            # the hash SEI above covers the full padded picture, like HM
            recons.append(crop_frame(rec, cfg.width, cfg.height))
        return b"".join(chunks), recons, stats

    def _entropy_encode(self, decisions, qp=None) -> bytes:
        return entropy_encode_slice(self.cfg, decisions, qp=qp)

    def reconstruct(self, pf, depth8, modes8, qp=None, modes4=None,
                    nxn8=None):
        """Normative reconstruction + coefficients through the backend
        (see __init__): "auto" runs a frame batch of one through
        `recon.encode_frame_planes_batched` (the reconstruction kernel on
        the card, the plain version on the CPU), "tu" through
        `recon_tu.reconstruct_tu`; then, as the config asks, deblocking
        and SAO on the device (a pure post-pass: intra prediction used the
        unfiltered samples). Only the final planes go to the host. "golden"
        returns `GoldenEncoder.encode_frame`'s result as it is.
        modes4/nxn8: NxN decisions; None = all CUs 2Nx2N.
        Returns (decisions dict of host arrays, recon Frame); with SAO
        on, decisions["sao"] holds the `sao.SaoParams`."""
        cfg = self.cfg
        qp = cfg.qp if qp is None else qp
        if modes4 is None:
            modes4 = np.repeat(np.repeat(modes8, 2, 0), 2, 1)
        if nxn8 is None:
            nxn8 = np.zeros_like(np.asarray(depth8), bool)
        if self.recon_backend == "golden":
            if qp != cfg.qp:
                raise NotImplementedError(
                    'recon_backend="golden" codes at cfg.qp only')
            return golden.GoldenEncoder(cfg).encode_frame(
                pf, depth8, modes8, modes4=modes4, nxn8=nxn8)
        if self.recon_backend == "tu":
            planes = recon_tu.reconstruct_tu(
                pf.y, pf.cb, pf.cr, depth8, modes8, qp=qp,
                pad_w=cfg.pad_width, pad_h=cfg.pad_height,
                device=self.device)
        else:
            planes = recon.encode_frame_planes_batched(
                *(np.asarray(a)[None] for a in (pf.y, pf.cb, pf.cr, depth8,
                                                modes4, nxn8)),
                qp=qp, pad_w=cfg.pad_width, pad_h=cfg.pad_height,
                rdoq=cfg.rdoq, device=self.device)
            planes = recon.FramePlanes(*(p[0] for p in planes))
        y, cb, cr = planes[:3]
        decisions = dict(depth8=depth8, modes8=modes8, modes4=modes4,
                         nxn8=nxn8)
        if cfg.deblock:
            y, cb, cr = deblock.deblock_frame(y, cb, cr, self._t(depth8), qp)
        if cfg.sao:
            params = sao.estimate_frame(self._t(pf.y), self._t(pf.cb),
                                        self._t(pf.cr), y, cb, cr, qp)
            y, cb, cr = sao.apply_frame(y, cb, cr, params)
            decisions["sao"] = params
        # to the host (waits for the device)
        rec = Frame(*(p.to(torch.uint8).cpu().numpy() for p in (y, cb, cr)))
        decisions.update(zip(("coef_y", "coef_cb", "coef_cr"),
                             (p.cpu().numpy() for p in planes[3:])))
        return decisions, rec


def entropy_encode_slice(cfg, decisions, qp=None) -> bytes:
    """Slice NAL: header (Python) + CABAC slice data (native C++). A
    failure of the native coder raises: there is no fallback coder."""
    if getattr(cfg, "cu_qp_delta", False):
        raise NotImplementedError("cu_qp_delta syntax is not ported yet")
    qp = cfg.qp if qp is None else qp
    bw = headers.start_idr_slice(cfg, qp)
    data = native.encode_slice_data(
        decisions["depth8"], decisions["modes8"],
        decisions["coef_y"], decisions["coef_cb"],
        decisions["coef_cr"], cfg.pad_width, cfg.pad_height,
        qp, modes4=decisions.get("modes4"), nxn8=decisions.get("nxn8"),
        sao=decisions.get("sao"))
    return nal_unit(NAL_IDR_W_RADL, bw.get_bytes() + data)
