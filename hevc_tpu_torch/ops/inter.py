"""Inter prediction: HEVC interpolation filters + batched motion search.

Normative MC filters (H.265 8.5.4.2): 8-tap luma quarter-pel, 4-tap
chroma eighth-pel, two-stage (horizontal then vertical) with 14-bit
intermediates. Behavioral counterpart: TComInterpolationFilter.cpp.

Motion estimation is a batched full search: every integer candidate of a
+-R window as one SAD reduction over all blocks (replaces HM's sequential
TZ search, TEncSearch.cpp:3663), then a quarter-pel sweep with the
normative filters. Used by the LDP pre-encode (forced 64x64, inter
2Nx2N — reference HM-16.5_Resi_Pre/TEncCu.cpp:388-397) and by the
P-slice search.

Everything is int32 and exact. Two things differ in form from a plain
transcription, not in value:

  * The integer search and the SAD field run one row of 2r+1 candidates
    at a time (`unfold` over the window's columns): all 289 candidates of
    a 1080p frame at once would be [289, 510, 64, 64] int32, 2.4 GB.
    The SADs of all candidates are stacked before one `argmin`, which
    returns the first minimum, so ties go to the lowest raster index as
    in the reference.
  * `predict_inter_blocks` filters each block with its own fraction's
    taps (gathered per block) instead of computing every fraction pair
    and selecting: a frac-0 axis is the tap row (.., 64, ..), and
    `64 * v == v << 6`, so the samples are the same.
"""

from __future__ import annotations

import numpy as np
import torch

# Table 8-11: luma quarter-pel filters, frac = 0..3
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], np.int32)

# Table 8-12: chroma eighth-pel filters, frac = 0..7
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], np.int32)


def _filter_h(x, coefs, taps):
    """Horizontal FIR over the last axis; x already includes the (taps-1)
    border columns. Output width = x.shape[-1] - taps + 1."""
    w = x.shape[-1] - taps + 1
    acc = torch.zeros(x.shape[:-1] + (w,), dtype=torch.int32,
                      device=x.device)
    for t in range(taps):
        if coefs[t]:
            acc += int(coefs[t]) * x[..., t:t + w]
    return acc


def _filter_v(x, coefs, taps):
    h = x.shape[-2] - taps + 1
    acc = torch.zeros(x.shape[:-2] + (h, x.shape[-1]), dtype=torch.int32,
                      device=x.device)
    for t in range(taps):
        if coefs[t]:
            acc += int(coefs[t]) * x[..., t:t + h, :]
    return acc


def _round_clip(val, bit_depth):
    """Uni-prediction rounding: the two stages kept 6 + 6 fractional bits."""
    shift = 12 - (bit_depth - 8)
    val = (val + (1 << (shift - 1))) >> shift
    return val.clamp_(0, (1 << bit_depth) - 1)


def _mc(ref_ext, fx, fy, out_h, out_w, bit_depth, table, lead):
    taps = table.shape[1]
    x = ref_ext.to(torch.int32)
    shift1 = bit_depth - 8               # 0 for 8-bit
    if fx == 0:
        tmp = x[..., :, lead:lead + out_w] << (6 - shift1)
    else:
        tmp = _filter_h(x, table[fx], taps) >> shift1
    if fy == 0:
        val = tmp[..., lead:lead + out_h, :] << 6
    else:
        val = _filter_v(tmp, table[fy], taps)
    return _round_clip(val, bit_depth)


def mc_luma(ref_ext, frac_x: int, frac_y: int, out_h: int, out_w: int,
            bit_depth: int = 8):
    """Quarter-pel MC of one window.

    ref_ext: [..., out_h + 7, out_w + 7] integer samples, positioned such
    that the top-left full-pel tap is at [3, 3] (i.e. the window includes
    the 3-left/3-top and 4-right/4-bottom filter border).
    frac_x/frac_y: 0..3. Returns [..., out_h, out_w] int32 samples.
    """
    return _mc(ref_ext, frac_x, frac_y, out_h, out_w, bit_depth,
               LUMA_FILTERS, 3)


def mc_chroma(ref_ext, frac_x: int, frac_y: int, out_h: int, out_w: int,
              bit_depth: int = 8):
    """Eighth-pel chroma MC. ref_ext: [..., out_h+3, out_w+3], top-left
    full-pel tap at [1, 1]."""
    return _mc(ref_ext, frac_x, frac_y, out_h, out_w, bit_depth,
               CHROMA_FILTERS, 1)


# ---------------------------------------------------------------------------
# Batched CTU motion search
# ---------------------------------------------------------------------------

def _gather_windows(ref_plane, x0, y0, ext_h, ext_w, ref_idx=None):
    """[B, ext_h, ext_w] int32 windows whose top-left sample is (x0, y0)
    per block ([B] each), rows and columns clamped to the plane. A
    multi-reference plane is [R, H, W] with `ref_idx` [B]."""
    h, w = ref_plane.shape[-2:]
    dev = ref_plane.device
    ys = (y0.to(torch.int64)[:, None, None]
          + torch.arange(ext_h, device=dev)[None, :, None]).clamp(0, h - 1)
    xs = (x0.to(torch.int64)[:, None, None]
          + torch.arange(ext_w, device=dev)[None, None, :]).clamp(0, w - 1)
    idx = ys * w + xs
    if ref_idx is not None:
        idx = idx + (ref_idx.to(torch.int64) * (h * w))[:, None, None]
    return ref_plane.reshape(-1)[idx].to(torch.int32)


def _row_abs_diffs(windows, cur, r):
    """For each candidate row dy = 0..2r: |window - cur| at the 2r+1
    column offsets of that row, [B, 64, 2r+1, 64] int32 (a generator, one
    row at a time)."""
    for dy in range(2 * r + 1):
        rows = windows[:, dy:dy + 64, :].unfold(2, 64, 1)  # [B,64,2r+1,64]
        yield (rows - cur[:, :, None, :]).abs_()


def integer_search_ctu(cur_tiles, ref_plane, origins, radius: int = 8):
    """Full integer-pel search for 64x64 blocks.

    cur_tiles: [B, 64, 64]; ref_plane: [H, W]; origins: [B, 2] (x, y).
    Returns (mv [B, 2] int32 (dx, dy), sad [B] int32).
    """
    r = radius
    size = 64 + 2 * r
    windows = _gather_windows(ref_plane, origins[:, 0] - r,
                              origins[:, 1] - r, size, size)
    cur = cur_tiles.to(torch.int32)
    # candidate c = dy_idx * (2r+1) + dx_idx, raster order
    sads = torch.cat([ad.sum((1, 3), dtype=torch.int32).t()
                      for ad in _row_abs_diffs(windows, cur, r)])
    best = torch.argmin(sads, dim=0)               # first minimum
    dy = best // (2 * r + 1) - r
    dx = best % (2 * r + 1) - r
    return (torch.stack([dx, dy], -1).to(torch.int32),
            sads.min(dim=0).values)


def predict_inter_ctu(ref_plane, origins, mv_q, *, is_luma=True):
    """Batched MC of 64x64 (or 32x32 chroma) tiles at quarter(eighth)-pel
    MVs. mv_q: [B, 2] in quarter-pel luma units. For chroma the same MV is
    interpreted at 1/8 resolution per 4:2:0.
    """
    return predict_inter_blocks(ref_plane, origins, mv_q,
                                64 if is_luma else 32, is_luma=is_luma)


def predict_inter_blocks(ref_plane, origins, mv_q, size: int, *,
                         is_luma=True, ref_idx=None, size_w=None):
    """Batched MC of size x size blocks at quarter(eighth)-pel MVs.

    origins: [B, 2] (x, y) in the plane's own coordinates (chroma origins
    are chroma coords). mv_q: [B, 2] quarter-pel *luma* MVs; chroma uses
    the same MV at 1/8 resolution per 4:2:0 (H.265 8.5.3.2.9).
    Multi-reference: pass ref_plane [R, H, W] + ref_idx [B] to gather
    each block's window from its own reference picture.
    size_w: optional block width for rectangular PUs (2NxN/Nx2N halves,
    TEncSearch.cpp:2912 predInterSearch partitions); size stays the
    height. Returns [B, size, size_w] int32.
    """
    size_h = size
    size_w = size if size_w is None else size_w
    mv_q = mv_q.to(torch.int32)
    if is_luma:
        table, lead = LUMA_FILTERS, 3
        mv_int, frac = mv_q >> 2, mv_q & 3
    else:
        table, lead = CHROMA_FILTERS, 1
        mv_int, frac = mv_q >> 3, mv_q & 7
    taps = table.shape[1]
    win = _gather_windows(ref_plane, origins[:, 0] + mv_int[:, 0] - lead,
                          origins[:, 1] + mv_int[:, 1] - lead,
                          size_h + taps - 1, size_w + taps - 1, ref_idx)
    # each block's own taps: [B, taps] for x and for y
    coef = torch.as_tensor(table, device=win.device)
    fx = coef[frac[:, 0].long()][:, :, None, None]
    fy = coef[frac[:, 1].long()][:, :, None, None]
    tmp = fx[:, 0] * win[..., 0:size_w]
    for t in range(1, taps):
        tmp += fx[:, t] * win[..., t:t + size_w]
    val = fy[:, 0] * tmp[:, 0:size_h]
    for t in range(1, taps):
        val += fy[:, t] * tmp[:, t:t + size_h]
    return _round_clip(val, 8)


def quarter_refine_blocks(cur_blocks, ref_plane, origins, mv_int,
                          size: int, ref_idx=None, size_w=None):
    """Quarter-pel refinement sweep around integer MVs for size x size
    luma blocks: mv_q = 4*mv_int + (dx, dy), dx/dy in [-3, 3].

    cur_blocks: [B, s, s] (or [B, s, size_w] for rectangular PUs);
    origins: [B, 2] (x, y); mv_int: [B, 2].
    Returns (mv_q [B, 2] int32, best_sad [B] int32).

    The horizontal pass depends on qdx alone, so it runs 7 times over the
    whole window, and the vertical pass of each qdy takes all 7 at once;
    the 49 predictions are the reference's `mc_luma` of each sub-window.
    """
    size_h = size
    size_w = size if size_w is None else size_w
    lead, border = 4, 9    # extra margin for -3/4 shifts
    mv_int = mv_int.to(torch.int32)
    win = _gather_windows(ref_plane, origins[:, 0] + mv_int[:, 0] - lead,
                          origins[:, 1] + mv_int[:, 1] - lead,
                          size_h + border, size_w + border, ref_idx)
    cur = cur_blocks.to(torch.int32)
    # horizontal stage of mc_luma for qdx = -3..3, all rows of the window
    hor = []
    for qdx in range(-3, 4):
        ix, fx = (qdx >> 2) + 1, qdx & 3   # +1 re-centers the window
        sub = win[:, :, ix:ix + size_w + 7]
        hor.append(sub[:, :, 3:3 + size_w] << 6 if fx == 0
                   else _filter_h(sub, LUMA_FILTERS[fx], 8))
    hor = torch.stack(hor)                          # [7, B, ext_h, sw]
    sads = []
    for qdy in range(-3, 4):
        iy, fy = (qdy >> 2) + 1, qdy & 3
        tmp = hor[:, :, iy:iy + size_h + 7]
        val = (tmp[:, :, 3:3 + size_h] << 6 if fy == 0
               else _filter_v(tmp, LUMA_FILTERS[fy], 8))
        pred = _round_clip(val, 8)
        sads.append((pred - cur).abs_().sum((2, 3), dtype=torch.int32))
    sads = torch.cat(sads)                          # [49, B], qdy outer
    best = torch.argmin(sads, dim=0)                # first minimum
    offs = torch.stack([best % 7 - 3, best // 7 - 3], -1).to(torch.int32)
    return mv_int * 4 + offs, sads.min(dim=0).values


def sad_grid8(cur_tiles, ref_plane, origins, radius: int = 8):
    """Integer-pel SAD field at 8x8-block granularity for 64x64 tiles.

    The quadtree ME primitive: SAD is additive over sub-blocks at a fixed
    candidate MV, so per-8x8 SADs aggregate bottom-up into exact SADs for
    16/32/64 blocks (replaces HM's per-PU TZ search TEncSearch.cpp:3663
    with one shared full-search field).

    cur_tiles: [B, 64, 64]; origins: [B, 2].
    Returns sads [n_cand, B, 8, 8] int32 with candidate (dy, dx) raster
    over the (2*radius+1)^2 window (cand c -> dy = c//(2r+1)-r, dx =
    c%(2r+1)-r).
    """
    B = cur_tiles.shape[0]
    r = radius
    n = 2 * r + 1
    span = 64 + 2 * r
    windows = _gather_windows(ref_plane, origins[:, 0] - r,
                              origins[:, 1] - r, span, span)
    cur = cur_tiles.to(torch.int32)
    rows = []
    for ad in _row_abs_diffs(windows, cur, r):      # [B, 64, n, 64]
        s = ad.reshape(B, 8, 8, n, 8, 8).sum((2, 5), dtype=torch.int32)
        rows.append(s.permute(2, 0, 1, 3))          # [n, B, 8, 8]
    return torch.cat(rows)
