"""Frame-batched All-Intra encoding on one device.

AI frames are independent, so the whole decide + reconstruct pipeline runs
over a frame batch: the search folds (frame, CTU) into its one leading
batch (`pipeline/search.search_frame` on [F, H, W] planes), and the
reconstruction kernel takes the frame as a grid axis
(`pipeline/recon.encode_frame_planes_batched`). The decisions stay on the
device between the two stages; only the coefficient planes (and, for the
picture-hash SEI, the reconstructions) come back to the host, where the
native CABAC coder packs the slices.

With `recon_backend="tu"` the decide runs with NxN off and the frame batch
is reconstructed by the TU-level wavefront (`pipeline/recon_tu`, plain
PyTorch): each frame's schedule is built on the host from its depth map,
and the schedules are stacked to common shapes.

Usage:
    penc = FrameParallelAI(cfg, cnn=eth_cnn.load_npz(path))
    stream, stats = penc.encode(frames, chunk=24)

Not ported yet (each raises `NotImplementedError`): a device mesh
(sharding the frame batch over several devices), and `ChainParallelLDP`.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.yuv import Frame, pad_frame
from ..entropy import headers
from ..models import eth_cnn, hcpm
from ..pipeline import golden, recon, recon_tu, search
from ..pipeline.ai import entropy_encode_slice


class FrameParallelAI:
    def __init__(self, cfg: headers.EncoderConfig,
                 cnn: Optional[eth_cnn.EthCnn] = None,
                 thresholds: Optional[hcpm.Thresholds] = None,
                 decide_chunk: int = 0, bucket_max_depth: bool = True,
                 device=None, *, mesh=None, recon_backend: str = "auto"):
        """cnn: an `eth_cnn.EthCnn`, or None for the ungated full search.
        device=None means the card; with no card that raises (pass
        device="cpu" to run on the CPU).

        decide_chunk > 0 splits the decide stage (CNN + mode/partition
        search) into sub-batches of that many frames while the
        reconstruction still runs over the whole frame batch: the search's
        35-mode intermediates grow with F, while the reconstruction is a
        chain of dependent launches whose cost hardly grows with F until
        the card is full — so the two stages want different batch sizes.

        bucket_max_depth (gated encodes only): frames whose HCPM gates rule
        out the deep CU levels are searched with a smaller `max_depth`
        (no depth-3 / NxN work at all), grouped by that depth — the
        counterpart of the reference's RD-check skipping
        (TEncCu.cpp:862-873). The stream is the same either way.

        recon_backend: "auto" (the reconstruction kernel on the card, its
        plain version on the CPU) or "tu" (`pipeline/recon_tu`, NxN off in
        the decide, RDOQ always on, as in the reference)."""
        if mesh is not None:
            raise NotImplementedError(
                "sharding the frame batch over a device mesh "
                "(parallel/mesh.py) is not ported yet")
        if recon_backend not in ("auto", "tu"):
            raise ValueError(f"unknown recon_backend {recon_backend!r}")
        if cfg.deblock or cfg.sao:
            # the reference FrameParallelAI writes the filter flags into
            # the parameter sets without filtering or coding SAO
            # parameters (hevc_tpu/parallel/frames.py:417-419), so there
            # is no reference to hold a filter step here to
            raise NotImplementedError(
                "FrameParallelAI does not run deblocking or SAO: the "
                "reference FrameParallelAI signals the filters without "
                "applying them, so no filtered path is ported here; use "
                "AIEncoder for filtered encodes")
        if getattr(cfg, "cu_qp_delta", False):
            raise NotImplementedError("per-CTU QP is not ported yet")
        self.cfg = cfg
        self.recon_backend = recon_backend
        # the TU backend codes TU == CU: its decide runs with NxN off
        self._nxn = cfg.nxn and recon_backend == "auto"
        self.device = resolve_device(device)
        self.cnn = cnn.to(self.device) if cnn is not None else None
        self.thr = thresholds or hcpm.DEFAULT_AI
        self.decide_chunk = decide_chunk
        self.bucket_max_depth = bucket_max_depth
        self._origins = torch.as_tensor(
            search.ctu_grid(cfg.pad_width, cfg.pad_height),
            dtype=torch.int64, device=self.device)
        # device -> host copies of a finished group run on a stream of
        # their own, so they do not queue behind the next group's kernels
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        #: (max_depth, frames) of every decide sub-batch of the last
        #: `encode` / `encode_batch`, in launch order
        self.decide_batches = []
        self.last_stats = {}

    # --- decide ------------------------------------------------------------

    def _cnn_probs(self, ys):
        """ETH-CNN over the CTUs of a frame batch -> [F, B, 21] probs."""
        cfg = self.cfg
        F = ys.shape[0]
        H64, W64 = cfg.ctus_y * 64, cfg.ctus_x * 64
        ypad = torch.nn.functional.pad(
            ys, (0, W64 - ys.shape[2], 0, H64 - ys.shape[1]))
        ctus = ypad.reshape(F, cfg.ctus_y, 64, cfg.ctus_x, 64)
        ctus = ctus.permute(0, 1, 3, 2, 4).reshape(-1, 64, 64)
        qp = torch.full((ctus.shape[0],), float(cfg.qp),
                        dtype=torch.float32, device=self.device)
        p = eth_cnn.apply(self.cnn, ctus, qp, thr_l1=self.thr.l1_lower,
                          thr_l2=self.thr.l2_lower)
        return p.reshape(F, -1, 21)

    def _assemble(self, t, u):
        """[F, B, u, u] per-CTU maps -> [F, pad_h*u/64, pad_w*u/64]."""
        cfg = self.cfg
        F = t.shape[0]
        nx, ny = cfg.ctus_x, cfg.ctus_y
        a = t.reshape(F, ny, nx, u, u).permute(0, 1, 3, 2, 4)
        a = a.reshape(F, ny * u, nx * u)
        return a[:, :cfg.pad_height * u // 64,
                 :cfg.pad_width * u // 64].contiguous()

    def _decide_stage(self, ys, cbs, crs, probs, max_depth=3):
        """One decide sub-batch: frame-level decision maps (depth8, modes8,
        modes4, nxn8), device tensors with a leading F."""
        cfg = self.cfg
        kw = {}
        if probs is not None:
            kw = dict(hcpm_probs=probs, thr_up=self.thr.up,
                      thr_down=self.thr.down, max_depth=max_depth)
        self.decide_batches.append((max_depth, int(ys.shape[0])))
        res = search.search_frame(
            ys, self._origins, pad_w=cfg.pad_width, pad_h=cfg.pad_height,
            n_ctu_x=cfg.ctus_x, qp=cfg.qp, cb_plane=cbs, cr_plane=crs,
            nxn=self._nxn, **kw)
        return (self._assemble(res.depth8, 8), self._assemble(res.modes8, 8),
                self._assemble(res.modes4, 16), self._assemble(res.nxn8, 8))

    def _frame_max_depths(self, probs):
        """Per-frame deepest gated CU level (host list; [F, B, 21] probs),
        floored at the forced-split depth of the padded frame."""
        cs = hcpm.split_gates(probs, self.thr)[1].cpu().numpy()
        floor = search.forced_depth_floor(self.cfg.pad_width,
                                          self.cfg.pad_height)
        out = []
        for f in range(cs.shape[0]):
            if cs[f, :, 5:21].any():
                md = 3
            elif cs[f, :, 1:5].any():
                md = 2
            elif cs[f, :, 0].any():
                md = 1
            else:
                md = 0
            out.append(max(md, floor))
        return out

    def _decide_bucketed(self, ys, cbs, crs):
        """CNN once, then one search per (max-depth bucket, sub-batch of
        at most decide_chunk frames)."""
        F = ys.shape[0]
        probs = self._cnn_probs(ys)
        md_f = self._frame_max_depths(probs)
        dc = self.decide_chunk if self.decide_chunk > 0 else F
        outs = [None] * F
        for md in sorted(set(md_f)):
            idx = [i for i in range(F) if md_f[i] == md]
            for i0 in range(0, len(idx), dc):
                grp = idx[i0:i0 + dc]
                sel = torch.as_tensor(grp, device=self.device)
                o = self._decide_stage(ys[sel], cbs[sel], crs[sel],
                                       probs[sel], md)
                for k, i in enumerate(grp):
                    outs[i] = tuple(x[k] for x in o)
        return tuple(torch.stack([o[k] for o in outs]) for k in range(4))

    def _decide(self, ys, cbs, crs):
        """Decide (optionally in sub-batches, see __init__.decide_chunk):
        frame-level decision maps (depth8, modes8, modes4, nxn8), device
        tensors with a leading F."""
        F = ys.shape[0]
        if self.cnn is not None and self.bucket_max_depth:
            return self._decide_bucketed(ys, cbs, crs)
        dc = self.decide_chunk if self.decide_chunk > 0 else F
        outs = []
        for i in range(0, F, dc):           # the last sub-batch may be short
            sl = slice(i, min(i + dc, F))
            probs = (self._cnn_probs(ys[sl]) if self.cnn is not None
                     else None)
            outs.append(self._decide_stage(ys[sl], cbs[sl], crs[sl], probs))
        return tuple(torch.cat([o[k] for o in outs]) for k in range(4))

    def _run_full(self, ys, cbs, crs):
        """Decide, then reconstruct the whole batch with the
        reconstruction kernel. Everything stays on the device; on a CUDA
        device nothing here waits for it."""
        cfg = self.cfg
        d, m, m4, nxn = self._decide(ys, cbs, crs)
        planes = recon.encode_frame_planes_batched(
            ys, cbs, crs, d, m4, nxn, qp=cfg.qp, pad_w=cfg.pad_width,
            pad_h=cfg.pad_height, rdoq=cfg.rdoq)
        return d, m, m4, nxn, planes

    def _run_tu(self, ys, cbs, crs):
        """Decide (NxN off) -> per-frame TU schedules (host, from the
        depth maps, which waits for the decide) -> the TU-level wavefront
        over the frame batch (device)."""
        cfg = self.cfg
        d, m, m4, nxn = self._decide(ys, cbs, crs)
        d_host = d.cpu().numpy()
        stacked = recon_tu.stack_schedules(
            [recon_tu.build_schedule(d_host[i])[0]
             for i in range(d_host.shape[0])])
        planes = recon_tu.encode_frame_planes_tu_inner(
            ys, cbs, crs, m, *(a for s8 in (1, 2, 4) for a in stacked[s8]),
            qp=cfg.qp, pad_w=cfg.pad_width, pad_h=cfg.pad_height)
        return d, m, m4, nxn, planes

    # --- one frame group: launch on the device, drain on the host -----------

    def _launch(self, frames):
        """Upload a frame group and enqueue its decide + reconstruction.
        On a CUDA device this returns while the device still works."""
        cfg = self.cfg
        pfs = [pad_frame(f, cfg.pad_width, cfg.pad_height) for f in frames]
        # uint8 upload; device code widens locally

        def up(name):
            return torch.as_tensor(
                np.stack([getattr(p, name) for p in pfs])).to(self.device)

        ys, cbs, crs = up("y"), up("cb"), up("cr")
        t0 = time.perf_counter()
        run = self._run_tu if self.recon_backend == "tu" else self._run_full
        out = run(ys, cbs, crs)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return out + (t0, done)

    def _to_host(self, tensors):
        if self._copy_stream is None:
            return [t.numpy() for t in tensors]
        with torch.cuda.stream(self._copy_stream):
            return [t.cpu().numpy() for t in tensors]

    def _drain(self, launched, n_frames, need_recon=True):
        """Wait for one group, copy its results to the host and pack its
        slices. Returns (chunks, recons, stats)."""
        d, m, m4, nxn, planes, t0, done = launched
        if done is not None:
            done.synchronize()
        t1 = time.perf_counter()
        d, m, m4, nxn, coef_y, coef_cb, coef_cr = self._to_host(
            [d, m, m4, nxn, planes.coef_y, planes.coef_cb, planes.coef_cr])
        if need_recon:
            rec_y, rec_cb, rec_cr = self._to_host(
                [planes.recon_y, planes.recon_cb, planes.recon_cr])
        t2 = time.perf_counter()
        chunks, recons = [], []
        for i in range(n_frames):
            decisions = dict(depth8=d[i], modes8=m[i], modes4=m4[i],
                             nxn8=nxn[i], coef_y=coef_y[i],
                             coef_cb=coef_cb[i], coef_cr=coef_cr[i])
            chunks.append(entropy_encode_slice(self.cfg, decisions))
            recons.append(Frame(rec_y[i], rec_cb[i], rec_cr[i])
                          if need_recon else None)
        t3 = time.perf_counter()
        return chunks, recons, {"device_s": t1 - t0, "transfer_s": t2 - t1,
                                "entropy_s": t3 - t2}

    def encode_batch(self, frames, need_recon=True):
        """Encode one batch of frames. Returns (slice NAL chunks, recons,
        decide + reconstruction seconds); `last_stats` holds device_s /
        transfer_s / entropy_s.

        need_recon=False skips the copy of the reconstruction planes to
        the host (recons come back as None): the kernel still computes
        them (they are the intra references), but the host needs them only
        for the picture-hash SEI."""
        self.decide_batches = []
        chunks, recons, stats = self._drain(self._launch(frames),
                                            len(frames), need_recon)
        self.last_stats = stats
        return chunks, recons, stats["device_s"]

    def encode(self, frames, with_hash_sei: bool = True, chunk: int = 0):
        """Encode a sequence; returns (annexb bytes, stats).

        chunk > 0 pipelines the encode in groups of that many frames: the
        device computes group N+1 while a worker thread drains group N
        (device -> host copies and CABAC packing). CUDA launches are
        asynchronous, so enqueueing the next group before touching the
        previous group's tensors overlaps device and host work."""
        cfg = self.cfg
        out = [headers.write_vps(cfg), headers.write_sps(cfg),
               headers.write_pps(cfg)]
        if chunk <= 0 or chunk >= len(frames):
            chunks, recons, _ = self.encode_batch(frames,
                                                  need_recon=with_hash_sei)
            stats = dict(self.last_stats)
        else:
            self.decide_batches = []
            groups = [frames[i:i + chunk]
                      for i in range(0, len(frames), chunk)]
            chunks, recons = [], []
            stats = {"device_s": 0.0, "transfer_s": 0.0, "entropy_s": 0.0}
            # Launch at most 2 groups ahead of the drain so live device
            # buffers stay bounded whatever the sequence length, while
            # device compute stays overlapped with host CABAC.
            with cf.ThreadPoolExecutor(max_workers=2) as pool:
                pending = collections.deque()   # futures, in group order
                gi = 0
                while gi < len(groups) or pending:
                    while gi < len(groups) and len(pending) < 2:
                        g = groups[gi]
                        pending.append(pool.submit(
                            self._drain, self._launch(g), len(g),
                            with_hash_sei))
                        gi += 1
                    ch, rc, st = pending.popleft().result()
                    chunks.extend(ch)
                    recons.extend(rc)
                    for k in stats:
                        stats[k] += st[k]
            self.last_stats = stats
        for ch, rec in zip(chunks, recons):
            out.append(ch)
            if with_hash_sei:
                tid, hs = golden.pic_hashes(rec, cfg.hash_type)
                out.append(headers.write_hash_sei(*hs, hash_type=tid))
        return b"".join(out), dict(stats)


class ChainParallelLDP:
    """GOP-chain pipeline parallelism for Low-Delay-P: not ported yet (it
    needs the LDP path and a device mesh)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ChainParallelLDP is not ported yet: it needs the Low-Delay-P "
            "path (pipeline/pframe.py) and a device mesh (parallel/mesh.py)")
