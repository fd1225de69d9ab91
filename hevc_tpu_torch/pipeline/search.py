"""Batched All-Intra mode/partition search.

Phase A of the AI pipeline: for every CTU of a frame *in parallel*,
evaluate all 35 intra modes at every CU node of the quadtree (1 + 4 + 16
+ 64 nodes) against original-pixel references, reduce to per-node best
modes by SATD, then decide the CU tree bottom-up — with ETH-CNN HCPM
probabilities gating the split decisions exactly like the reference's
three-way rule (TEncCu.cpp:419-463, re-expressed as masks).

There is no sequential dependency because search predictions use original
pixels (the normative reconstruction path recomputes prediction from
reconstructed samples). Node sizes 4, 8 and 16 go through
`intra_mm.satd_all_modes` (the CUDA kernel on the card); 32 and 64 through
the gather formulation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import hcpm as hcpm_lib
from ..ops import bits as bits_lib
from ..ops import cost, intra, intra_mm, quant as quant_lib, refs, transforms


class SearchResult(NamedTuple):
    depth8: torch.Tensor    # [B, 8, 8] int32 depth of each 8x8 unit
    modes8: torch.Tensor    # [B, 8, 8] int32 luma mode of each 8x8 unit
    split0: torch.Tensor    # [B] bool
    split1: torch.Tensor    # [B, 2, 2] bool
    split2: torch.Tensor    # [B, 4, 4] bool
    modes4: torch.Tensor    # [B, 16, 16] int32 luma mode per 4x4 unit
    nxn8: torch.Tensor      # [B, 8, 8] bool: NxN part mode (depth-3 CUs)


@functools.lru_cache(maxsize=None)
def _node_offsets(depth: int):
    """Raster-ordered (x, y) offsets of the 4^depth nodes at a depth."""
    n = 1 << depth
    size = 64 >> depth
    ys, xs = np.mgrid[0:n, 0:n]
    return (xs.reshape(-1) * size).astype(np.int32), \
        (ys.reshape(-1) * size).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _node_offsets_t(depth: int, device):
    """[nd, 2] int64 (x, y) node offsets on `device`."""
    offx, offy = _node_offsets(depth)
    return torch.as_tensor(np.stack([offx, offy], -1), dtype=torch.int64,
                           device=device)


def _rep2(t, k):
    """Repeat each element k times along the last two dims."""
    return t.repeat_interleave(k, -2).repeat_interleave(k, -1)


def _gather_blocks(plane, origins, size, frame=None):
    """[N, size, size] int32 blocks at `origins` [N, 2]; reads beyond the
    plane are clipped to its edge. plane: [H, W], or a frame batch
    [F, H, W] with `frame` [N] int64 naming each block's frame."""
    h, w = plane.shape[-2:]
    ar = torch.arange(size, device=plane.device)
    ys = torch.clamp(origins[:, 1:2, None] + ar[None, :, None], 0, h - 1)
    xs = torch.clamp(origins[:, 0:1, None] + ar[None, None, :], 0, w - 1)
    at = ys * w + xs
    if frame is not None:
        at = at + frame[:, None, None] * (h * w)
    return plane.reshape(-1)[at].to(torch.int32)


def _per_block(frame, k):
    """Frame index of each of the k blocks made from every CTU."""
    return None if frame is None else frame.repeat_interleave(k)


def _best_mode_per_node(y_plane, ctu_origins, depth, pad_w, pad_h, n_ctu_x,
                        frame=None):
    """For all CTUs x all nodes at `depth`: best mode + SATD. `frame`
    [B]: the frame of each CTU when y_plane is a batch [F, H, W].

    Returns (best_mode [B, nd], best_satd [B, nd]) with nd = 4^depth.
    """
    B = ctu_origins.shape[0]
    size = 64 >> depth
    off = _node_offsets_t(depth, y_plane.device)
    nd = off.shape[0]
    origins = (ctu_origins[:, None, :] + off[None]).reshape(B * nd, 2)
    frame = _per_block(frame, nd)

    r = refs.prepare_refs(y_plane, origins, size, pad_w, pad_h, n_ctu_x,
                          frame=frame)
    rf = intra.filter_refs(r)
    orig = _gather_blocks(y_plane, origins, size, frame)

    if size <= 16:
        # weight-table formulation (the CUDA kernel on the card),
        # bit-exact vs the gather path
        satds = intra_mm.satd_all_modes(r, rf, orig, size)
    else:
        preds_u = intra.predict_all_modes(r, size, component="luma")
        preds_f = intra.predict_all_modes(rf, size, component="luma")
        fmask = intra._filter_mask_t(size, y_plane.device)
        preds = torch.where(fmask[None, :, None, None], preds_f, preds_u)
        satds = cost.satd(orig[:, None], preds, block=8)     # [B*nd, 35]
    # argmin takes the first minimum (lowest mode number) on a tie
    best_mode = torch.argmin(satds, dim=1).to(torch.int32)
    best_satd = torch.amin(satds, dim=1)
    return (best_mode.reshape(B, nd), best_satd.reshape(B, nd))


def _tu_origins(ctu_origins, depth, tu_off, div=1):
    """[B * nd * n_tu, 2] TU origins: CTU origin + node offset (both
    divided by `div` for chroma) + TU offset."""
    B = ctu_origins.shape[0]
    off = _node_offsets_t(depth, ctu_origins.device)
    base = ctu_origins[:, None, :] // div + off[None] // div
    t = torch.as_tensor(tu_off, dtype=torch.int64, device=ctu_origins.device)
    return (base[:, :, None, :] + t[None, None]).reshape(-1, 2)


def _leaf_cost(pred, orig, qp, lam, dist_w, is_luma, use_dst=False):
    """[N] float32: dist_w * SSE(reconstruction) + lam * estimated bits."""
    resi = orig - pred
    lvl = quant_lib.quantize(
        transforms.forward_transform(resi, use_dst=use_dst), qp)
    rresi = transforms.inverse_transform(quant_lib.dequantize(lvl, qp),
                                         use_dst=use_dst)
    rec = torch.clamp(pred + rresi, 0, 255)
    d = (rec - orig).to(torch.float32)
    sse = (d * d).sum((-2, -1))
    bits = bits_lib.tu_bits(lvl, is_luma=is_luma)
    if dist_w is not None:
        sse = dist_w * sse
    return sse + lam * bits


def _refined_costs(y_plane, ctu_origins, depth, modes, qp, lam, *,
                   pad_w, pad_h, n_ctu_x, use_dst=False, frame=None):
    """RD cost of each node coded as a leaf with its chosen mode:
    SSE(reconstruction) + lambda * estimated bits (HM J = D + lambda*R,
    TComRdCost::calcRdCost behavioral equivalent on original-pixel refs).
    depth 4 = the 4x4 sub-PUs of NxN 8x8 CUs (use_dst=True: intra luma
    4x4 codes DST-VII). Returns [B, nd] float32."""
    B = ctu_origins.shape[0]
    size = 64 >> depth
    tu = 32 if size == 64 else size
    nd = 4 ** depth

    # TU origins: 4 TUs per 64-node, else 1
    if size == 64:
        tu_off = [[0, 0], [32, 0], [0, 32], [32, 32]]
    else:
        tu_off = [[0, 0]]
    n_tu = len(tu_off)
    origins = _tu_origins(ctu_origins, depth, tu_off)
    modes_t = modes.reshape(B, nd, 1).expand(B, nd, n_tu).reshape(-1)

    frame = _per_block(frame, nd * n_tu)

    r = refs.prepare_refs(y_plane, origins, tu, pad_w, pad_h, n_ctu_x,
                          frame=frame)
    rf = intra.filter_refs(r)
    r_use = intra.select_filtered_batch(r, rf, modes_t, tu)
    pred = intra.predict_selected_modes(r_use, modes_t, tu)
    orig = _gather_blocks(y_plane, origins, tu, frame)
    c = _leaf_cost(pred, orig, qp, lam, None, True, use_dst)
    return c.reshape(B, nd, n_tu).sum(-1)


def _refined_chroma_costs(c_plane, ctu_origins, depth, modes, cqp, lam,
                          dist_w, *, pad_w, pad_h, n_ctu_x, frame=None):
    """Chroma-component leaf RD contribution per node: weighted SSE +
    lambda * bits of the DM-mode (= luma mode) chroma TB(s). Mirrors the
    reconstruction tiling (pipeline/recon.code_ctu): one TB of size
    luma_size/2 per CU, except the 64 CU which codes four 16x16 chroma
    TBs. dist_w = HM chroma distortion weight 2^((qp-qp_c)/3)
    (TComRdCost::setCbDistortionWeight behavioral twin).
    Returns [B, nd] float32."""
    B = ctu_origins.shape[0]
    size = 64 >> depth
    tu = 16 if size == 64 else size >> 1
    nd = 4 ** depth
    pad_wc, pad_hc = pad_w // 2, pad_h // 2

    if size == 64:
        tu_off = [[0, 0], [16, 0], [0, 16], [16, 16]]
    else:
        tu_off = [[0, 0]]
    n_tu = len(tu_off)
    origins = _tu_origins(ctu_origins, depth, tu_off, div=2)
    modes_t = modes.reshape(B, nd, 1).expand(B, nd, n_tu).reshape(-1)

    frame = _per_block(frame, nd * n_tu)

    r = refs.prepare_refs(c_plane, origins, tu, pad_wc, pad_hc, n_ctu_x,
                          scale=2, frame=frame)
    pred = intra.predict_selected_modes(r, modes_t, tu, component="chroma")
    orig = _gather_blocks(c_plane, origins, tu, frame)
    c = _leaf_cost(pred, orig, cqp, lam, dist_w, False)
    return c.reshape(B, nd, n_tu).sum(-1)


def forced_split_mask(ctu_origins, depth: int, pad_w: int, pad_h: int):
    """[B, n, n] bool: CUs crossing the padded-frame boundary must split
    (TEncCu.cpp:424-428 semantics)."""
    B = ctu_origins.shape[0]
    size = 64 >> depth
    off = _node_offsets_t(depth, ctu_origins.device)
    gx = ctu_origins[:, 0:1] + off[None, :, 0]
    gy = ctu_origins[:, 1:2] + off[None, :, 1]
    n = 1 << depth
    inside = (gx + size <= pad_w) & (gy + size <= pad_h)
    started = (gx < pad_w) & (gy < pad_h)
    return (~inside & started).reshape(B, n, n)


def decide_tree(costs, ctu_origins, *, pad_w, pad_h, split_bits,
                hcpm_probs=None, thr_up=(1.1, 1.1, 1.1),
                thr_down=(-0.1, -0.1, -0.1)):
    """Bottom-up gated CU-tree reduction (TEncCu.cpp:419-463 three-way
    rule as masks).

    costs: {depth: [B, 4^depth]} leaf RD costs.
    Returns (split0 [B], split1 [B,2,2], split2 [B,4,4], depth8 [B,8,8]).
    """
    B = ctu_origins.shape[0]
    dev = ctu_origins.device
    cost3 = costs[3].reshape(B, 8, 8)
    cost2 = costs[2].reshape(B, 4, 4)
    cost1 = costs[1].reshape(B, 2, 2)
    cost0 = costs[0].reshape(B, 1, 1)

    if hcpm_probs is not None:
        thr = hcpm_lib.Thresholds(up=tuple(thr_up), down=tuple(thr_down))
        chk_cur, chk_split = hcpm_lib.split_gates(hcpm_probs, thr)
        cur0, split_ok0 = chk_cur[:, 0], chk_split[:, 0]
        cur1 = chk_cur[:, 1:5].reshape(B, 2, 2)
        split_ok1 = chk_split[:, 1:5].reshape(B, 2, 2)
        cur2 = chk_cur[:, 5:21].reshape(B, 4, 4)
        split_ok2 = chk_split[:, 5:21].reshape(B, 4, 4)
    else:
        tr = lambda *s: torch.ones(s, dtype=torch.bool, device=dev)
        cur0, split_ok0 = tr(B), tr(B)
        cur1 = split_ok1 = tr(B, 2, 2)
        cur2 = split_ok2 = tr(B, 4, 4)

    def pool4(c):
        b, n, _ = c.shape
        return c.reshape(b, n // 2, 2, n // 2, 2).sum((2, 4))

    # level 2 (16 -> 8)
    sub3 = pool4(cost3) + split_bits
    f2 = forced_split_mask(ctu_origins, 2, pad_w, pad_h)
    choose2 = f2 | (split_ok2 & (~cur2 | (sub3 < cost2)))
    best2 = torch.where(choose2, sub3, cost2)
    # level 1 (32 -> 16)
    sub2 = pool4(best2) + split_bits
    f1 = forced_split_mask(ctu_origins, 1, pad_w, pad_h)
    choose1 = f1 | (split_ok1 & (~cur1 | (sub2 < cost1)))
    best1 = torch.where(choose1, sub2, cost1)
    # level 0 (64 -> 32)
    sub1 = pool4(best1) + split_bits
    f0 = forced_split_mask(ctu_origins, 0, pad_w, pad_h).reshape(B)
    choose0 = f0 | (split_ok0 & (~cur0 | (sub1[:, 0, 0] < cost0[:, 0, 0])))

    split0 = choose0
    split1 = choose1 & split0[:, None, None]
    split2 = choose2 & _rep2(split1, 2)

    depth4 = hcpm_lib.depth_map_from_decisions(split0, split1, split2)
    depth8 = _rep2(depth4, 2)                      # [B, 8, 8]
    return split0, split1, split2, depth8


def forced_depth_floor(pad_w: int, pad_h: int) -> int:
    """Smallest depth whose CU size tiles the padded frame exactly —
    boundary CTUs are force-split down to this depth (TEncCu.cpp:424-428),
    so a frame-level max-depth early exit can never go shallower."""
    for d in range(4):
        if pad_w % (64 >> d) == 0 and pad_h % (64 >> d) == 0:
            return d
    return 3


def gate_max_depth(hcpm_probs, thr, pad_w: int, pad_h: int) -> int:
    """Deepest CU level any HCPM split gate leaves open this frame (a
    host-side scalar that narrows the frame's search: the `max_depth` of
    `search_frame` and `psearch.p_search_frame`), floored at the
    forced-split depth of the padded frame."""
    cs = hcpm_lib.split_gates(hcpm_probs, thr)[1].cpu()
    if cs[:, 5:21].any():
        md = 3
    elif cs[:, 1:5].any():
        md = 2
    elif cs[:, 0].any():
        md = 1
    else:
        md = 0
    return max(md, forced_depth_floor(pad_w, pad_h))


def search_frame(y_plane, ctu_origins, *, pad_w, pad_h, n_ctu_x, qp,
                 hcpm_probs: Optional[torch.Tensor] = None,
                 thr_up=(1.1, 1.1, 1.1), thr_down=(-0.1, -0.1, -0.1),
                 rd_refine: bool = True, cb_plane=None, cr_plane=None,
                 nxn: bool = True, max_depth: int = 3):
    """Run the partition/mode search for all CTUs of one frame, or of a
    batch of frames.

    y_plane: [pad_h, pad_w] luma tensor (uint8/int32); its device is the
      device of the whole search. A batch [F, pad_h, pad_w] (chroma planes
      [F, pad_h//2, pad_w//2], hcpm_probs [F, B, 21]) folds (frame, CTU)
      into the one leading batch the search carries anyway: the frames'
      CTUs are searched together, the 35-mode SATD kernel is launched once
      per node size for all of them, and every field of the result gets a
      leading F.
    ctu_origins: [B, 2] int64 (x, y) top-left of each CTU of a frame.
    hcpm_probs: [B, 21] ETH-CNN outputs, or None (no gating: thresholds
      default to always-check-both, i.e. pure search).
    cb_plane/cr_plane: optional [pad_h//2, pad_w//2] chroma; when given
      (and rd_refine) the tree decisions include the DM-mode chroma RD
      contribution (HM weighs all three components in xCheckBestMode).
    max_depth: do not evaluate CU depths beyond this — the analogue of the
      reference's RD-check skipping (TEncCu.cpp:862-873 bCheckSub): the
      caller narrows whole frames when the HCPM gates rule the deep levels
      out (AIEncoder.max_depth_exit). Clamped up to the forced-split floor.
    Returns SearchResult.
    """
    n_frames = None
    frame = None
    if y_plane.dim() == 3:
        n_frames, per_frame = y_plane.shape[0], ctu_origins.shape[0]
        frame = torch.arange(n_frames, device=y_plane.device
                             ).repeat_interleave(per_frame)
        ctu_origins = ctu_origins.repeat(n_frames, 1)
        if hcpm_probs is not None:
            hcpm_probs = hcpm_probs.reshape(n_frames * per_frame, 21)
    B = ctu_origins.shape[0]
    dev = y_plane.device
    f32 = torch.float32
    # lambda is a Python double rounded once to float32, like every
    # product with it below
    lam = float(np.float32(0.57 * 2.0 ** ((qp - 12) / 3.0)))
    lam_sqrt = float(np.sqrt(np.float32(lam)))

    def lam_times(x):
        return float(np.float32(lam) * np.float32(x))

    max_depth = min(3, max(max_depth, forced_depth_floor(pad_w, pad_h)))
    INF = 3.4e38
    modes = {}
    satds = {}
    for d in range(4):
        if d > max_depth:
            # never selected (infinite cost below); shape placeholders
            modes[d] = torch.zeros((B, 4 ** d), dtype=torch.int32, device=dev)
            satds[d] = torch.full((B, 4 ** d), INF, dtype=f32, device=dev)
            continue
        m, s = _best_mode_per_node(y_plane, ctu_origins, d, pad_w, pad_h,
                                   n_ctu_x, frame)
        modes[d] = m
        satds[d] = s.to(f32)

    nxn8 = torch.zeros((B, 8, 8), dtype=torch.bool, device=dev)
    modes4_nxn = None
    if rd_refine:
        # true RD leaf costs (SSE + lambda*bits) for the SATD-chosen mode;
        # per-CU overhead: intra dir ~5.5 bits + flags/cbfs ~4 bits
        ovh = lam_times(9.5)
        costs = {d: (_refined_costs(y_plane, ctu_origins, d, modes[d], qp,
                                    lam, pad_w=pad_w, pad_h=pad_h,
                                    n_ctu_x=n_ctu_x, frame=frame) + ovh
                     if d <= max_depth else satds[d])
                 for d in range(4)}
        chroma_cost = None
        if cb_plane is not None:
            cqp = quant_lib.chroma_qp(qp)
            dist_w = float(np.float32(2.0 ** ((qp - cqp) / 3.0)))

            def chroma_cost(d, m):
                out = 0.0
                for cp in (cb_plane, cr_plane):
                    out = out + _refined_chroma_costs(
                        cp, ctu_origins, d, m, cqp, lam, dist_w,
                        pad_w=pad_w, pad_h=pad_h, n_ctu_x=n_ctu_x,
                        frame=frame)
                return out

            for d in range(max_depth + 1):
                costs[d] = costs[d] + chroma_cost(d, modes[d])
        if nxn and max_depth == 3:
            # NxN candidate at depth 3: four 4x4 PUs/TUs (DST), competing
            # against 2Nx2N per 8x8 CU (HM xCheckRDCostIntra SIZE_NxN).
            m4, _ = _best_mode_per_node(y_plane, ctu_origins, 4, pad_w,
                                        pad_h, n_ctu_x, frame)
            modes4_nxn = m4
            cost4 = _refined_costs(y_plane, ctu_origins, 4, m4, qp, lam,
                                   pad_w=pad_w, pad_h=pad_h,
                                   n_ctu_x=n_ctu_x, use_dst=True,
                                   frame=frame)
            # pool the 16x16 grid of 4x4 leaves into 8x8-CU sums
            c4 = cost4.reshape(B, 8, 2, 8, 2).sum((2, 4)).reshape(B, 64)
            # overhead: part bit + 3 extra intra dirs + extra cbf coding
            nxn_cost = c4 + lam_times(27.0)
            if chroma_cost is not None:
                m4_tl = m4.reshape(B, 8, 2, 8, 2)[:, :, 0, :, 0]
                nxn_cost = nxn_cost + chroma_cost(
                    3, m4_tl.reshape(B, 64))
            pick_nxn = nxn_cost < costs[3]
            costs[3] = torch.where(pick_nxn, nxn_cost, costs[3])
            nxn8 = pick_nxn.reshape(B, 8, 8)
        split_bits = lam_times(2.0)
    else:
        ovh = float(np.float32(lam_sqrt) * np.float32(9.5))
        costs = {d: satds[d] + ovh for d in range(4)}
        split_bits = float(np.float32(lam_sqrt) * np.float32(2.0))
    split0, split1, split2, depth8 = decide_tree(
        costs, ctu_origins, pad_w=pad_w, pad_h=pad_h,
        split_bits=split_bits, hcpm_probs=hcpm_probs, thr_up=thr_up,
        thr_down=thr_down)

    # scatter modes: per 8x8 unit pick by its depth
    m0 = modes[0].reshape(B, 1, 1).expand(B, 8, 8)
    m1 = _rep2(modes[1].reshape(B, 2, 2), 4)
    m2 = _rep2(modes[2].reshape(B, 4, 4), 2)
    m3 = modes[3].reshape(B, 8, 8)
    stacked = torch.stack([m0, m1, m2, m3], dim=-1)
    modes8 = torch.gather(stacked, -1,
                          depth8[..., None].to(torch.int64))[..., 0]

    # 4x4-granularity modes: NxN leaves use their per-PU modes, everything
    # else repeats the CU mode; nxn8 only applies where depth == 3
    nxn8 = nxn8 & (depth8 == 3)
    modes4 = _rep2(modes8, 2)
    if modes4_nxn is not None:
        m4g = modes4_nxn.reshape(B, 8, 2, 8, 2).permute(0, 1, 3, 2, 4)
        m4g = m4g.reshape(B, 8, 8, 4)  # per 8x8 unit: its 4 sub-modes
        nxn_rep = nxn8[..., None]
        m4sel = torch.where(nxn_rep, m4g, modes8[..., None])
        # back to [B, 16, 16]
        m4sel = m4sel.reshape(B, 8, 8, 2, 2).permute(0, 1, 3, 2, 4)
        modes4 = m4sel.reshape(B, 16, 16)
        # keep modes8 = the PU0 mode (chroma DM + neighbour derivation)
        modes8 = modes4[:, ::2, ::2]

    res = SearchResult(depth8=depth8, modes8=modes8, split0=split0,
                       split1=split1, split2=split2, modes4=modes4,
                       nxn8=nxn8)
    if n_frames is not None:
        res = SearchResult(*(t.reshape(n_frames, -1, *t.shape[1:])
                             for t in res))
    return res


def ctu_grid(pad_w: int, pad_h: int, ctu: int = 64):
    """[B, 2] raster-ordered CTU origins for a padded frame."""
    nx = -(-pad_w // ctu)
    ny = -(-pad_h // ctu)
    ys, xs = np.mgrid[0:ny, 0:nx]
    return np.stack([xs.reshape(-1) * ctu, ys.reshape(-1) * ctu],
                    -1).astype(np.int32)
