"""Decoder-side reconstruction from parsed decision maps.

Counterpart of TDecCu::decompressCtu + TDecSlice loop-filter invocation
(TDecCu.cpp:128, TDecGop.cpp:145-150), built on the same normative ops
the encoder uses, so encoder and decoder cannot drift:

* intra CUs: the sequential z-order walk on the host (prediction needs
  reconstructed neighbours) through `pipeline.golden._predict_tu` and
  the NumPy twins of ops/quant and ops/transforms;
* inter CUs: ops/inter.predict_inter_blocks on the decoder's device,
  one batch per prediction-block shape (the CU sizes of 2Nx2N CUs and
  the halves of rectangular CUs), then the residual of every inter TU,
  one batch per TU size and QP, through ops/quant.dequantize and
  ops/transforms.inverse_transform;
* the in-loop filters: ops/deblock and ops/sao on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import zorder
from ..core.yuv import Frame
from ..ops import deblock, inter, quant, sao, transforms
from ..pipeline.golden import _predict_tu


def _add_residual(recon, coef, x0, y0, n, qp, pred, use_dst=False):
    lvl = coef[y0:y0 + n, x0:x0 + n]
    if np.any(lvl):
        deq = quant.dequantize_np(lvl[None], qp)[0]
        rresi = transforms.inverse_transform_np(deq[None],
                                                use_dst=use_dst)[0]
    else:
        rresi = 0
    recon[y0:y0 + n, x0:x0 + n] = np.clip(pred + rresi, 0, 255)


def _code_intra_cu(recon, coef, zmap, x0, y0, size, mode, qp, W, H):
    """One 2Nx2N intra CU (TU = CU, 64 splits into four 32s) into the
    recon planes, z-order neighbours already reconstructed."""
    cqp = quant.chroma_qp(qp)

    def tu(c, x, y, n, q, component, scale=1):
        pred = _predict_tu(recon[c], zmap, x, y, n, mode,
                           component=component, pad_w=W // scale,
                           pad_h=H // scale, scale=scale)
        _add_residual(recon[c], coef[c], x, y, n, q, pred)

    if size == 64:
        for (dx, dy) in ((0, 0), (32, 0), (0, 32), (32, 32)):
            tu(0, x0 + dx, y0 + dy, 32, qp, "luma")
        for (dx, dy) in ((0, 0), (16, 0), (0, 16), (16, 16)):
            for c in (1, 2):
                tu(c, (x0 >> 1) + dx, (y0 >> 1) + dy, 16, cqp, "chroma", 2)
    else:
        tu(0, x0, y0, size, qp, "luma")
        for c in (1, 2):
            tu(c, x0 >> 1, y0 >> 1, size >> 1, cqp, "chroma", 2)


def recon_intra_frame(dec: dict, W: int, H: int, qp: int) -> Frame:
    """Reconstruct an I picture from ISliceDecoder output (pre-filter),
    on the host."""
    depth8 = dec["depth8"]
    modes4 = dec["modes4"]
    nxn8 = dec["nxn8"]
    coef = (dec["coef_y"], dec["coef_cb"], dec["coef_cr"])
    zmap = zorder.frame_zmap(W, H)
    cqp = quant.chroma_qp(qp)
    recon = (np.zeros((H, W), np.int32),
             np.zeros((H // 2, W // 2), np.int32),
             np.zeros((H // 2, W // 2), np.int32))

    def tu_nxn(c, x0, y0, mode, q, component, scale=1, use_dst=False):
        pred = _predict_tu(recon[c], zmap, x0, y0, 4, mode,
                           component=component, pad_w=W // scale,
                           pad_h=H // scale, scale=scale)
        _add_residual(recon[c], coef[c], x0, y0, 4, q, pred, use_dst)

    for (x0, y0, size) in _collect_cus(depth8, W, H):
        if size == 8 and nxn8[y0 >> 3, x0 >> 3]:
            for (dx, dy) in ((0, 0), (4, 0), (0, 4), (4, 4)):
                m = int(modes4[(y0 + dy) >> 2, (x0 + dx) >> 2])
                tu_nxn(0, x0 + dx, y0 + dy, m, qp, "luma", use_dst=True)
            pu0 = int(modes4[y0 >> 2, x0 >> 2])
            for c in (1, 2):
                tu_nxn(c, x0 >> 1, y0 >> 1, pu0, cqp, "chroma", scale=2)
        else:
            _code_intra_cu(recon, coef, zmap, x0, y0, size,
                           int(modes4[y0 >> 2, x0 >> 2]), qp, W, H)
    return Frame(*(p.astype(np.uint8) for p in recon))


def _collect_cus(depth8, W, H):
    """[(x0, y0, size)] leaves of the coded quadtree, z-order."""
    out = []

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
            out.append((x0, y0, size))

    nx = -(-W // 64)
    for ci in range(nx * (-(-H // 64))):
        cy, cx = divmod(ci, nx)
        walk(cx * 64, cy * 64, 64, 0)
    return out


def _block_index(xy, h, w, device):
    """(rows, cols) index tensors [B, h, w] of B blocks at origins xy."""
    xy = torch.as_tensor(np.asarray(xy, np.int64), device=device)
    rows = xy[:, 1, None, None] + torch.arange(h, device=device)[None, :,
                                                                 None]
    cols = xy[:, 0, None, None] + torch.arange(w, device=device)[None,
                                                                 None, :]
    return rows, cols


def recon_inter_frame(dec: dict, refs, W: int, H: int, qp: int,
                      device) -> tuple:
    """Reconstruct a P/B picture (pre-filter) on `device`.
    refs: RefPicList0, each picture as (y, cb, cr) int32 planes on the
    device. Returns the (y, cb, cr) int32 planes on the device."""
    depth8 = dec["depth8"]
    mvq8 = dec["mvq8"]
    ref8 = dec.get("ref8")
    if ref8 is None:
        ref8 = np.zeros_like(depth8)
    intra8 = dec.get("intra8")
    if intra8 is not None and not intra8.any():
        intra8 = None
    part8 = dec.get("part8")
    if part8 is None:
        part8 = np.zeros_like(depth8)
    # per-CTB QP (cu_qp_delta streams): each CU dequantizes at its CTB's
    # signalled QP (8.6.1, diff_cu_qp_depth = 0)
    qp_ctb = dec.get("qp_ctb")

    def qp_at(x, y):
        return qp if qp_ctb is None else int(qp_ctb[y >> 6, x >> 6])

    ref_planes = [torch.stack([r[c] for r in refs]) for c in range(3)]
    pred = [torch.zeros((H, W), dtype=torch.int32, device=device),
            torch.zeros((H // 2, W // 2), dtype=torch.int32, device=device),
            torch.zeros((H // 2, W // 2), dtype=torch.int32, device=device)]
    cus = _collect_cus(depth8, W, H)
    # prediction blocks by shape (h, w): their origins, MVs and refIdx;
    # TUs by (size, QP, plane): their origins
    blocks, tus = {}, {}
    for (x0, y0, size) in cus:
        if intra8 is not None and intra8[y0 >> 3, x0 >> 3]:
            continue
        part = int(part8[y0 >> 3, x0 >> 3])
        h = size >> 1
        pus = ([(x0, y0, size, size)] if part == 0
               else [(x0, y0, size, h), (x0, y0 + h, size, h)] if part == 1
               else [(x0, y0, h, size), (x0 + h, y0, h, size)])
        for (xp, yp, wp, hp) in pus:
            blocks.setdefault((hp, wp), []).append(
                (xp, yp, *mvq8[yp >> 3, xp >> 3], ref8[yp >> 3, xp >> 3]))
        # luma TU: CU (64 -> four 32s); rectangular CUs split once
        # (7.4.9.8 interSplitFlag); chroma TU: half the luma TU
        tu = min(size, 32) if part == 0 else (32 if size == 64 else h)
        q = qp_at(x0, y0)
        for ty in range(0, size, tu):
            for tx in range(0, size, tu):
                tus.setdefault((tu, q, 0), []).append((x0 + tx, y0 + ty))
                for c in (1, 2):
                    tus.setdefault((tu >> 1, quant.chroma_qp(q), c),
                                   []).append(((x0 + tx) >> 1,
                                               (y0 + ty) >> 1))
    for (hp, wp), group in blocks.items():
        a = np.asarray(group, np.int64)
        org = torch.as_tensor(a[:, :2], device=device)
        mv = torch.as_tensor(a[:, 2:4], device=device)
        ri = torch.as_tensor(a[:, 4], device=device)
        for c in range(3):
            s = 0 if c == 0 else 1
            p = inter.predict_inter_blocks(
                ref_planes[c], org >> s, mv, hp >> s, is_luma=c == 0,
                ref_idx=ri, size_w=wp >> s)
            rows, cols = _block_index(a[:, :2] >> s, hp >> s, wp >> s,
                                      device)
            pred[c][rows, cols] = p
    rec = [p.clone() for p in pred]
    coef = [torch.as_tensor(dec[k]).to(device)
            for k in ("coef_y", "coef_cb", "coef_cr")]
    for (n, q, c), org in tus.items():
        rows, cols = _block_index(org, n, n, device)
        resi = transforms.inverse_transform(
            quant.dequantize(coef[c][rows, cols], q))
        rec[c][rows, cols] = (pred[c][rows, cols] + resi.to(torch.int32)
                              ).clamp_(0, 255)
    if intra8 is not None:
        # intra CUs: sequential z-order patch from reconstructed
        # neighbours (the decoder side of pipeline/intra_p)
        rec_h = [r.cpu().numpy() for r in rec]
        coef_h = (dec["coef_y"], dec["coef_cb"], dec["coef_cr"])
        zmap = zorder.frame_zmap(W, H)
        for (x0, y0, size) in cus:
            if intra8[y0 >> 3, x0 >> 3]:
                _code_intra_cu(rec_h, coef_h, zmap, x0, y0, size,
                               int(dec["imodes4"][y0 >> 2, x0 >> 2]),
                               qp_at(x0, y0), W, H)
        rec = [torch.as_tensor(r).to(device) for r in rec_h]
    return tuple(rec)


def apply_loop_filters(rec, dec: dict, qp: int, *, deblock_on: bool,
                       sao_on: bool, inter_pic: bool, device):
    """In-loop filters in normative order, deblocking then SAO, on the
    device. rec: (y, cb, cr) planes (arrays or tensors). Returns the
    (y, cb, cr) int32 planes on the device."""
    y, cb, cr = (torch.as_tensor(np.asarray(p) if not torch.is_tensor(p)
                                 else p).to(device).to(torch.int32)
                 for p in rec)
    if deblock_on:
        if inter_pic:
            intra8 = dec.get("intra8")
            if intra8 is not None and not intra8.any():
                intra8 = None
            part8 = dec.get("part8")
            if part8 is not None and not part8.any():
                part8 = None
            y, cb, cr = deblock.deblock_frame_inter(
                y, cb, cr, dec["depth8"], dec["mvq8"],
                torch.as_tensor(dec["coef_y"]).to(device), qp,
                ref8=dec.get("ref8"), intra8=intra8, part8=part8)
        else:
            y, cb, cr = deblock.deblock_frame(y, cb, cr, dec["depth8"], qp)
    if sao_on and dec.get("sao") is not None:
        y, cb, cr = sao.apply_frame(y, cb, cr, dec["sao"])
    return tuple(p.to(torch.int32) for p in (y, cb, cr))
