"""SAO — sample adaptive offset (H.265 8.7.3) as whole-plane tensor ops.

Behavioral counterpart: HM TComSampleAdaptiveOffset.cpp (normative
apply, SAOProcess :614) + TEncSampleAdaptiveOffset.cpp (statistics and
parameter decision). Three stages:

- statistics (device): per-CTU edge-offset category counts/sums for all
  4 EO classes (computed together as one [4, H, W] category tensor) and
  32-band histograms of the deblocked picture. A plane's EO counts and
  sums are one `index_add_` over the key `ctu_id * 16 + class * 4 +
  category - 1`, its band counts and sums one over `ctu_id * 32 + band`.
  Integer sums do not depend on order, so the result equals a per-CTU
  masked sum exactly;
- decision (host NumPy, float64, `np.argmin`'s first-index tie rule):
  tiny per-CTU arrays -> per-CTU (type, class/band, offsets) minimizing
  D + lambda*R with HM's fast delta-distortion form
  dD = sum_cat(count*off^2 - 2*off*sum). It is kept on the host so that
  the decision is the same arithmetic wherever the picture was coded;
  this costs one device-to-host copy of the statistics per frame;
- apply (device): normative per-pixel offsets as a masked whole-plane op
  (every EO class is computed, per-pixel selection by the CTU's class).

SAO reads the *deblocked* picture and produces the final reference/
output picture.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# EO class -> (neighbor 0, neighbor 1) offsets (dy, dx); 8.7.3 Table 8-16
EO_NEIGH = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (-1, 1, 1, -1))

SAO_NONE, SAO_BAND, SAO_EDGE = 0, 1, 2
MAX_ABS = 7   # (1 << (min(bitDepth,10) - 5)) - 1 for 8-bit

#: edgeIdx 0 -> cat 1, 1 -> cat 2, 2 -> none (0), 3 -> cat 3, 4 -> cat 4
_EDGE_TO_CAT = (1, 2, 0, 3, 4)


class SaoParams(NamedTuple):
    """Per-CTU decided parameters, one set per component (numpy)."""
    type_idx: np.ndarray   # [3, B] int32 (0 none / 1 band / 2 edge)
    eo_class: np.ndarray   # [3, B] int32 0..3 (valid when edge)
    band_pos: np.ndarray   # [3, B] int32 0..31 (valid when band)
    offsets: np.ndarray    # [3, B, 4] int32 signed


def _t(a, device=None, dtype=torch.int32):
    return torch.as_tensor(a, dtype=dtype, device=device)


def _eo_cat(plane):
    """[4, H, W] int32 EO category (0 = none, 1..4) of every sample under
    each of the 4 EO classes at once; 0 also where a class's neighbour
    lies outside the plane (the reference's `_eo_cat` gives one class and
    a separate validity mask; an invalid sample counts and changes
    nothing in either form)."""
    H, W = plane.shape
    pp = F.pad(plane, (1, 1, 1, 1))       # border values are never used

    def nb(dy, dx):
        return pp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    n0 = torch.stack([nb(dy0, dx0) for dy0, dx0, _, _ in EO_NEIGH])
    n1 = torch.stack([nb(dy1, dx1) for _, _, dy1, dx1 in EO_NEIGH])
    edge = torch.sign(plane - n0) + torch.sign(plane - n1) + 2
    cat = torch.tensor(_EDGE_TO_CAT, dtype=torch.int32,
                       device=plane.device)[edge.long()]
    # neighbours outside the plane: columns for classes 0, 2, 3 (dx != 0),
    # rows for classes 1, 2, 3 (dy != 0)
    cat[[0, 2, 3], :, 0] = 0
    cat[[0, 2, 3], :, W - 1] = 0
    cat[1:, 0] = 0
    cat[1:, H - 1] = 0
    return cat


def _ctu_ids(H: int, W: int, ctu: int, device):
    """[H, W] int64 raster CTU index of every sample."""
    cy = torch.arange(H, device=device)[:, None] // ctu
    cx = torch.arange(W, device=device)[None, :] // ctu
    return cy * -(-W // ctu) + cx


def _keyed_sums(key, diff, n_keys: int):
    """Counts and sums of int32 `diff` per key in [0, n_keys); keys in
    [n_keys, 2 * n_keys) are thrown away. The adds are atomic, and adds
    to one address wait on each other: a sample that counts nowhere gets
    a discarded key spread like the real ones, not one shared drop key.
    A CTU's sums stay far below 2^31 (64 * 64 samples, |diff| <= 255).
    Returns ([n_keys], [n_keys]) int32."""
    vals = torch.stack([torch.ones_like(diff), diff], -1).reshape(-1, 2)
    acc = torch.zeros((2 * n_keys, 2), dtype=torch.int32, device=diff.device)
    acc.index_add_(0, key.reshape(-1), vals)
    return acc[:n_keys, 0], acc[:n_keys, 1]


def sao_stats(orig, rec, ctu: int):
    """Per-CTU SAO statistics of one component plane.

    orig/rec: [H, W] (rec = deblocked). ctu: CTU span in this plane's
    units (64 luma, 32 chroma 4:2:0).
    Returns int32 tensors (eo_cnt [B,4,4], eo_sum [B,4,4], b_cnt [B,32],
    b_sum [B,32]) on rec's device.
    """
    rec = _t(rec)
    orig = _t(orig, rec.device)
    H, W = rec.shape
    ci = _ctu_ids(H, W, ctu, rec.device)
    B = -(-H // ctu) * -(-W // ctu)
    diff = orig - rec
    # EO: key = ctu * 16 + cls * 4 + (cat - 1); category 0 -> the
    # discarded bank at B * 16 + ctu * 16 + cls * 4
    cat = _eo_cat(rec)                                     # [4, H, W]
    cls4 = torch.arange(0, 16, 4, device=rec.device)[:, None, None]
    key = torch.where(cat > 0, ci * 16 + cls4 + cat - 1,
                      ci * 16 + cls4 + B * 16)
    eo_cnt, eo_sum = _keyed_sums(key, diff.expand(4, H, W), B * 16)
    # bands: key = ctu * 32 + (rec >> 3)
    b_cnt, b_sum = _keyed_sums(ci * 32 + (rec >> 3), diff, B * 32)
    return (eo_cnt.reshape(B, 4, 4), eo_sum.reshape(B, 4, 4),
            b_cnt.reshape(B, 32), b_sum.reshape(B, 32))


def _best_offset(cnt, sm, lo, hi, lam):
    """Per-element best integer offset in [lo, hi] minimizing
    cnt*off^2 - 2*off*sum + lam*|off| bits-ish; vectorized numpy."""
    best_off = np.zeros_like(sm, np.int64)
    best_d = np.zeros_like(sm, np.float64)
    for off in range(lo, hi + 1):
        if off == 0:
            continue
        d = cnt * off * off - 2.0 * off * sm + lam * (abs(off) + 1)
        take = d < best_d
        best_off = np.where(take, off, best_off)
        best_d = np.where(take, d, best_d)
    return best_off, best_d


def sao_decide(eo_cnt, eo_sum, b_cnt, b_sum, lam: float):
    """Per-CTU (type, class/band, offsets) for one component (numpy).

    Returns (type_idx [B], eo_class [B], band_pos [B], offsets [B,4],
    cost [B]) where cost is the delta-J vs SAO-off (<= 0).
    """
    eo_cnt = np.asarray(eo_cnt, np.float64)
    eo_sum = np.asarray(eo_sum, np.float64)
    b_cnt = np.asarray(b_cnt, np.float64)
    b_sum = np.asarray(b_sum, np.float64)
    B = eo_cnt.shape[0]

    # EO: cat 1,2 offsets in [0,7]; cat 3,4 in [-7,0]
    off12, d12 = _best_offset(eo_cnt[:, :, :2], eo_sum[:, :, :2], 0,
                              MAX_ABS, lam)
    off34, d34 = _best_offset(eo_cnt[:, :, 2:], eo_sum[:, :, 2:],
                              -MAX_ABS, 0, lam)
    eo_off = np.concatenate([off12, off34], -1)          # [B, 4cls, 4cat]
    eo_d = d12.sum(-1) + d34.sum(-1) + lam * 4.0         # [B, 4cls]
    best_cls = np.argmin(eo_d, axis=1)
    eo_best_d = eo_d[np.arange(B), best_cls]
    eo_best_off = eo_off[np.arange(B), best_cls]

    # BO: best 4-consecutive-band window (wrapped)
    boff, bd = _best_offset(b_cnt, b_sum, -MAX_ABS, MAX_ABS, lam)  # [B,32]
    wins = np.stack([np.take(bd, (np.arange(4) + s) % 32, axis=1).sum(1)
                     for s in range(32)], 1)             # [B, 32]
    best_pos = np.argmin(wins, axis=1)
    bo_best_d = wins[np.arange(B), best_pos] + lam * 7.0
    bo_best_off = np.stack(
        [boff[np.arange(B), (best_pos + k) % 32] for k in range(4)], -1)

    type_idx = np.zeros(B, np.int32)
    use_eo = (eo_best_d < 0) & (eo_best_d <= bo_best_d)
    use_bo = (bo_best_d < 0) & ~use_eo
    type_idx[use_eo] = SAO_EDGE
    type_idx[use_bo] = SAO_BAND
    cost = np.where(use_eo, eo_best_d, np.where(use_bo, bo_best_d, 0.0))

    offsets = np.zeros((B, 4), np.int32)
    offsets[use_eo] = eo_best_off[use_eo].astype(np.int32)
    offsets[use_bo] = bo_best_off[use_bo].astype(np.int32)
    return (type_idx, best_cls.astype(np.int32),
            best_pos.astype(np.int32), offsets, cost)


def sao_apply(rec, type_idx, eo_class, band_pos, offsets, ctu: int):
    """Normative SAO apply for one plane.

    rec: [H, W] deblocked samples. Per-CTU params as arrays indexed by
    raster CTU id ([B], [B], [B], [B,4]). Returns int32 [H, W] on rec's
    device.
    """
    rec = _t(rec)
    dev = rec.device
    H, W = rec.shape
    ci = _ctu_ids(H, W, ctu, dev)                        # [H, W]
    t = _t(type_idx, dev)[ci]
    cls_map = _t(eo_class, dev, torch.int64)[ci]
    pos_map = _t(band_pos, dev)[ci]
    offs = _t(offsets, dev).reshape(-1)                  # [B * 4]

    # EO: category map of every class, select by the CTU's class
    cat_sel = torch.gather(_eo_cat(rec), 0, cls_map[None])[0]  # [H, W] 0..4
    eo_off = torch.where(cat_sel > 0,
                         offs[ci * 4 + (cat_sel - 1).clamp(min=0)], 0)

    # BO: bandTable[(pos + k) & 31] = k+1
    k = ((rec >> 3) - pos_map) & 31
    bo_off = torch.where(k < 4, offs[ci * 4 + k.clamp(max=3)], 0)

    off = torch.where(t == SAO_EDGE, eo_off,
                      torch.where(t == SAO_BAND, bo_off, 0))
    return (rec + off).clamp(0, 255)


def frame_stats(orig_y, orig_cb, orig_cr, rec_y, rec_cb, rec_cr):
    """`sao_stats` of the three planes, brought to the host in one copy:
    a list of three (eo_cnt, eo_sum, b_cnt, b_sum) numpy tuples."""
    stats = [sao_stats(orig_y, rec_y, 64), sao_stats(orig_cb, rec_cb, 32),
             sao_stats(orig_cr, rec_cr, 32)]
    arrays = [s for st in stats for s in st]
    flat = torch.cat([s.reshape(-1) for s in arrays]).cpu()
    host = iter(f.numpy().reshape(s.shape) for f, s in
                zip(flat.split([s.numel() for s in arrays]), arrays))
    return [tuple(next(host) for _ in st) for st in stats]


def decide_frame(stats, qp: int) -> SaoParams:
    """Per-CTU SAO parameters of all components from `frame_stats`.

    Chroma (cb, cr) shares type_idx and eo_class per the syntax
    (7.3.8.3): chroma SAO is on only where both components' best types
    (and EO classes) agree.
    """
    lam = float(0.57 * 2.0 ** ((qp - 12) / 3.0))
    sy, scb, scr = stats
    ty, cy_, py, oy, _ = sao_decide(*sy, lam)

    # joint chroma: evaluate both components under each candidate
    lam_c = lam
    tcb, ccb, pcb, ocb, dcb = sao_decide(*scb, lam_c)
    tcr, ccr, pcr, ocr, dcr = sao_decide(*scr, lam_c)
    B = ty.shape[0]
    tc = np.zeros(B, np.int32)
    cc = np.zeros(B, np.int32)
    # keep it simple: chroma SAO on only when both best types agree
    agree = (tcb == tcr) & (tcb > 0) & ((tcb != SAO_EDGE) | (ccb == ccr))
    tc[agree] = tcb[agree]
    cc[agree] = ccb[agree]
    ocb2 = np.where(agree[:, None], ocb, 0).astype(np.int32)
    ocr2 = np.where(agree[:, None], ocr, 0).astype(np.int32)

    return SaoParams(
        type_idx=np.stack([ty, tc, tc]),
        eo_class=np.stack([cy_, cc, cc]),
        band_pos=np.stack([py, pcb, pcr]),
        offsets=np.stack([oy, ocb2, ocr2]))


def estimate_frame(orig_y, orig_cb, orig_cr, rec_y, rec_cb, rec_cr,
                   qp: int) -> SaoParams:
    """Decide per-CTU SAO parameters for all components: statistics on
    the planes' device, decision on the host (`frame_stats`,
    `decide_frame`)."""
    return decide_frame(frame_stats(orig_y, orig_cb, orig_cr, rec_y, rec_cb,
                                    rec_cr), qp)


def apply_frame(rec_y, rec_cb, rec_cr, p: SaoParams):
    y = sao_apply(rec_y, p.type_idx[0], p.eo_class[0], p.band_pos[0],
                  p.offsets[0], 64)
    cb = sao_apply(rec_cb, p.type_idx[1], p.eo_class[1], p.band_pos[1],
                   p.offsets[1], 32)
    cr = sao_apply(rec_cr, p.type_idx[2], p.eo_class[2], p.band_pos[2],
                   p.offsets[2], 32)
    return y, cb, cr
