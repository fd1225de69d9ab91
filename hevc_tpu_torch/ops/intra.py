"""HEVC intra prediction: reference samples + the 35 prediction modes.

Normative per H.265 8.4.4.2 (the decoder computes exactly this, so encoder
reconstruction must match bit-for-bit). Behavioral counterpart in the
reference: TComPrediction.cpp:412 (predIntraAng) + TComPattern.cpp
(reference-sample substitution/filtering).

Reference samples live in one linear array r[0..4N] (bottom-left ..
corner .. top-right). For every (mode, N) the angular projection/interp
indices are STATIC tables, so a whole mode's prediction is two gathers +
one weighted add — vectorized over [batch, mode] with no data-dependent
control flow.

Layout of r (length 4N+1):
  r[0]        = p[-1][2N-1]      (bottom-most left sample)
  r[2N-1]     = p[-1][0]
  r[2N]       = p[-1][-1]        (corner)
  r[2N+1]     = p[0][-1]
  r[4N]       = p[2N-1][-1]      (right-most top sample)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Mode -> displacement angle (H.265 Table 8-4).
INTRA_ANGLES = {
    2: 32, 3: 26, 4: 21, 5: 17, 6: 13, 7: 9, 8: 5, 9: 2, 10: 0,
    11: -2, 12: -5, 13: -9, 14: -13, 15: -17, 16: -21, 17: -26, 18: -32,
    19: -26, 20: -21, 21: -17, 22: -13, 23: -9, 24: -5, 25: -2, 26: 0,
    27: 2, 28: 5, 29: 9, 30: 13, 31: 17, 32: 21, 33: 26, 34: 32,
}
# Mode -> inverse angle (round(8192/|angle|), Table 8-5; modes 11..25 only).
INV_ANGLES = {
    11: -4096, 12: -1638, 13: -910, 14: -630, 15: -482, 16: -390, 17: -315,
    18: -256, 19: -315, 20: -390, 21: -482, 22: -630, 23: -910, 24: -1638,
    25: -4096,
}
PLANAR, DC, HOR, VER = 0, 1, 10, 26


def ref_filter_flag(mode: int, n: int) -> bool:
    """Luma reference-smoothing decision (8.4.4.2.3)."""
    if mode == DC or n == 4:
        return False
    min_dist = min(abs(mode - HOR), abs(mode - VER))
    # n=64 only occurs in 64x64 PB *search* (TUs are <=32); treat like 32.
    thres = {8: 7, 16: 1, 32: 0, 64: 0}[n]
    return min_dist > thres


# ---------------------------------------------------------------------------
# Static index tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _angular_tables(mode: int, n: int):
    """Static gather tables for one angular mode at TU size n.

    Returns (idx0, idx1, fact): arrays of shape [n, n] with indices into the
    linear ref array r[0..4n] and the 5-bit interpolation factor, such that
      pred[y][x] = ((32-fact)*r[idx0] + fact*r[idx1] + 16) >> 5
    For modes < 18 the prediction is computed transposed internally; these
    tables already account for that (they are expressed in output [y][x]).
    """
    assert 2 <= mode <= 34
    angle = INTRA_ANGLES[mode]
    vertical = mode >= 18

    # Work in the "main-reference" frame (top row for vertical modes, left
    # column for horizontal ones; horizontal output is transposed into place).
    # Extended main array em[k], k in [-n .. 2n]:
    #   vertical:   em[k>=0] = p[k-1][-1] -> r[2n+k]; projected side samples
    #               em[k<0] = p[-1][j], j = ((k*invAngle+128)>>8)-1 -> r[2n-1-j]
    #   horizontal: em[k>=0] = p[-1][k-1] -> r[2n-k]; side = p[j][-1] -> r[2n+1+j]
    idx0 = np.zeros((n, n), np.int32)
    idx1 = np.zeros((n, n), np.int32)
    fact = np.zeros((n, n), np.int32)
    for y in range(n):
        i_idx = ((y + 1) * angle) >> 5
        i_fact = ((y + 1) * angle) & 31
        for x in range(n):
            k1 = x + i_idx + 1   # em index of first tap
            k2 = k1 + 1
            if vertical:
                def em(k):
                    if k >= 0:
                        return 2 * n + k          # p[k-1][-1]
                    j = ((k * INV_ANGLES[mode] + 128) >> 8) - 1
                    return 2 * n - 1 - j          # p[-1][j]
            else:
                def em(k):
                    if k >= 0:
                        return 2 * n - k          # p[-1][k-1]
                    j = ((k * INV_ANGLES[mode] + 128) >> 8) - 1
                    return 2 * n + 1 + j          # p[j][-1]
            a = em(k1)
            # When iFact == 0 the spec uses the single-tap branch; the second
            # tap (weight 0) may fall outside the ref array — alias it to the
            # first so the gather stays in bounds.
            b = em(k2) if i_fact != 0 else a
            if vertical:
                idx0[y, x], idx1[y, x], fact[y, x] = a, b, i_fact
            else:
                idx0[x, y], idx1[x, y], fact[x, y] = a, b, i_fact
    return idx0, idx1, fact


# ---------------------------------------------------------------------------
# NumPy twins (the host's normative TU coder, pipeline/golden._code_tu)
# ---------------------------------------------------------------------------

def substitute_refs_np(r, avail, bit_depth=8):
    """Reference sample substitution (8.4.4.2.2) on linear arrays.

    r: [B, 4N+1] sample values (garbage where unavailable).
    avail: [B, 4N+1] bool.
    """
    r = np.array(r, np.int32)
    avail = np.asarray(avail, bool)
    out = np.empty_like(r)
    for b in range(r.shape[0]):
        if not avail[b].any():
            out[b] = 1 << (bit_depth - 1)
            continue
        row = r[b].copy()
        # forward fill from index 0; leading unavailable take first available
        first = np.argmax(avail[b])
        row[:first] = row[first]
        for i in range(1, row.shape[0]):
            if not avail[b, i] and i > first:
                row[i] = row[i - 1]
        out[b] = row
    return out


def filter_refs_np(r):
    """[1 2 1]/4 smoothing along the linear ref array, endpoints kept."""
    r = np.asarray(r, np.int32)
    f = r.copy()
    f[..., 1:-1] = (r[..., :-2] + 2 * r[..., 1:-1] + r[..., 2:] + 2) >> 2
    return f


def predict_np(r, mode, n, *, component="luma", bit_depth=8):
    """Predict one [B, n, n] block from linear refs [B, 4n+1] for `mode`."""
    r = np.asarray(r, np.int32)
    B = r.shape[0]
    left = r[:, 2 * n - 1::-1]        # left[j] = p[-1][j], j=0..2n-1
    top = r[:, 2 * n + 1:]            # top[i] = p[i][-1], i=0..2n-1
    corner = r[:, 2 * n]
    maxv = (1 << bit_depth) - 1
    shift = int(n).bit_length()       # log2(n) + 1

    if mode == PLANAR:
        xx = np.arange(n)[None, None, :]
        yy = np.arange(n)[None, :, None]
        return (((n - 1 - xx) * left[:, :n, None] + (xx + 1) * top[:, n, None, None]
                 + (n - 1 - yy) * top[:, None, :n]
                 + (yy + 1) * left[:, n, None, None] + n) >> shift
                ).astype(np.int32)

    if mode == DC:
        dc = (top[:, :n].sum(1) + left[:, :n].sum(1) + n) >> shift
        pred = np.broadcast_to(dc[:, None, None], (B, n, n)).copy()
        if component == "luma" and n < 32:
            pred[:, 0, 1:] = (top[:, 1:n] + 3 * dc[:, None] + 2) >> 2
            pred[:, 1:, 0] = (left[:, 1:n] + 3 * dc[:, None] + 2) >> 2
            pred[:, 0, 0] = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
        return pred.astype(np.int32)

    idx0, idx1, fact = _angular_tables(mode, n)
    pred = ((32 - fact)[None] * r[:, idx0] + fact[None] * r[:, idx1]
            + 16) >> 5
    if component == "luma" and n < 32:
        if mode == VER:
            delta = (left[:, :n] - corner[:, None]) >> 1
            pred[:, :, 0] = np.clip(top[:, 0][:, None] + delta, 0, maxv)
        elif mode == HOR:
            delta = (top[:, :n] - corner[:, None]) >> 1
            pred[:, 0, :] = np.clip(left[:, 0][:, None] + delta, 0, maxv)
    return pred.astype(np.int32)


# ---------------------------------------------------------------------------
# Batched torch versions
# ---------------------------------------------------------------------------

def substitute_refs(r, avail, bit_depth=8):
    """Vectorized substitution: forward-fill last-available, then head fill."""
    r = r.to(torch.int32)
    L = r.shape[-1]
    idx = torch.arange(L, device=r.device)
    pos = torch.where(avail, idx, torch.full_like(idx, -1))
    last = torch.cummax(pos, dim=-1).values
    first = torch.argmax(avail.to(torch.uint8), dim=-1)   # first available idx
    gather_idx = torch.where(last >= 0, last, first[..., None])
    out = torch.gather(r, -1, gather_idx)
    any_avail = avail.any(dim=-1, keepdim=True)
    return torch.where(any_avail, out,
                       torch.full_like(out, 1 << (bit_depth - 1)))


def filter_refs(r):
    r = r.to(torch.int32)
    mid = (r[..., :-2] + 2 * r[..., 1:-1] + r[..., 2:] + 2) >> 2
    return torch.cat([r[..., :1], mid, r[..., -1:]], dim=-1)


@functools.lru_cache(maxsize=None)
def _all_mode_tables(n: int):
    """Stacked gather tables for modes 2..34: [33, n, n] each."""
    i0 = np.stack([_angular_tables(m, n)[0] for m in range(2, 35)])
    i1 = np.stack([_angular_tables(m, n)[1] for m in range(2, 35)])
    fa = np.stack([_angular_tables(m, n)[2] for m in range(2, 35)])
    return i0, i1, fa


@functools.lru_cache(maxsize=None)
def _all_mode_tables_t(n: int, device):
    """(_all_mode_tables as tensors) i0, i1: [33, n*n] int64; fa: int32."""
    i0, i1, fa = _all_mode_tables(n)
    return (torch.as_tensor(i0.reshape(33, -1), dtype=torch.int64,
                            device=device),
            torch.as_tensor(i1.reshape(33, -1), dtype=torch.int64,
                            device=device),
            torch.as_tensor(fa.reshape(33, -1), dtype=torch.int32,
                            device=device))


@functools.lru_cache(maxsize=None)
def _filter_mask_t(n: int, device):
    return torch.as_tensor(
        np.array([ref_filter_flag(m, n) for m in range(35)], bool),
        device=device)


def _split(r, n):
    """(left [.., 2n] top-down, top [.., 2n], corner [..]) views of r."""
    left = torch.flip(r[..., :2 * n], dims=(-1,))
    top = r[..., 2 * n + 1:]
    corner = r[..., 2 * n]
    return left, top, corner


def _planar(left, top, n):
    """[B, n, n] planar prediction from left/top [B, 2n]."""
    log2n = int(n).bit_length() - 1
    xs = torch.arange(n, device=left.device, dtype=torch.int32)
    T = top[:, :n]
    Lf = left[:, :n]
    tr = top[:, n]
    bl = left[:, n]
    return ((n - 1 - xs)[None, None, :] * Lf[:, :, None]
            + (xs + 1)[None, None, :] * tr[:, None, None]
            + (n - 1 - xs)[None, :, None] * T[:, None, :]
            + (xs + 1)[None, :, None] * bl[:, None, None]
            + n) >> (log2n + 1)


def _dc(left, top, n, component):
    """[B, n, n] DC prediction incl. the luma edge smoothing (n < 32)."""
    B = left.shape[0]
    log2n = int(n).bit_length() - 1
    T = top[:, :n]
    Lf = left[:, :n]
    dc = (T.sum(1, dtype=torch.int32) + Lf.sum(1, dtype=torch.int32)
          + n) >> (log2n + 1)
    dcp = dc[:, None, None].expand(B, n, n)
    if component == "luma" and n < 32:
        dcp = dcp.clone()
        dcp[:, 0, :] = (T + 3 * dc[:, None] + 2) >> 2
        dcp[:, :, 0] = (Lf + 3 * dc[:, None] + 2) >> 2
        dcp[:, 0, 0] = (Lf[:, 0] + 2 * dc + T[:, 0] + 2) >> 2
    return dcp


def predict_all_modes(r, n, *, component="luma", bit_depth=8):
    """All 35 modes batched: r [B, 4n+1] -> pred [B, 35, n, n] int32.

    Mode order: index 0 = planar, 1 = DC, 2..34 = angular (HEVC numbering).
    Luma applies the normative DC/H/V boundary smoothing for n < 32.
    """
    r = r.to(torch.int32)
    B = r.shape[0]
    left, top, corner = _split(r, n)
    maxv = (1 << bit_depth) - 1

    # Angular modes: one gather over stacked tables.
    i0, i1, fa = _all_mode_tables_t(n, r.device)
    p0 = r[:, i0.reshape(-1)].reshape(B, 33, n, n)
    p1 = r[:, i1.reshape(-1)].reshape(B, 33, n, n)
    fa = fa.reshape(1, 33, n, n)
    ang = ((32 - fa) * p0 + fa * p1 + 16) >> 5

    pl = _planar(left, top, n)
    dcp = _dc(left, top, n, component)
    if component == "luma" and n < 32:
        T = top[:, :n]
        Lf = left[:, :n]
        # VER (mode 26 = angular idx 24): leftmost column smoothing.
        delta_v = (Lf - corner[:, None]) >> 1
        ang[:, VER - 2, :, 0] = torch.clamp(top[:, 0][:, None] + delta_v,
                                            0, maxv)
        # HOR (mode 10 = angular idx 8): top row smoothing.
        delta_h = (T - corner[:, None]) >> 1
        ang[:, HOR - 2, 0, :] = torch.clamp(left[:, 0][:, None] + delta_h,
                                            0, maxv)

    return torch.cat([pl[:, None], dcp[:, None], ang], dim=1)


def predict_selected_modes(r, modes, n, *, component="luma", bit_depth=8):
    """Batched single-mode prediction with per-block modes.

    r: [B, 4n+1] substituted refs (caller picks filtered/unfiltered per
    block via select_filtered_batch); modes: [B] integer tensor.
    Returns [B, n, n] int32. Used by the RD-refined search and by the
    reconstruction (one prediction per block instead of 35).
    """
    r = r.to(torch.int32)
    B = r.shape[0]
    modes = modes.to(torch.int64)
    left, top, corner = _split(r, n)
    maxv = (1 << bit_depth) - 1

    i0s, i1s, fas = _all_mode_tables_t(n, r.device)
    midx = torch.clamp(modes - 2, 0, 32)
    p0 = torch.gather(r, 1, i0s[midx]).reshape(B, n, n)
    p1 = torch.gather(r, 1, i1s[midx]).reshape(B, n, n)
    fa = fas[midx].reshape(B, n, n)
    ang = ((32 - fa) * p0 + fa * p1 + 16) >> 5

    pl = _planar(left, top, n)
    dcp = _dc(left, top, n, component)
    if component == "luma" and n < 32:
        T = top[:, :n]
        Lf = left[:, :n]
        ver_col = torch.clamp(top[:, 0][:, None] + ((Lf - corner[:, None]) >> 1),
                              0, maxv)
        hor_row = torch.clamp(left[:, 0][:, None] + ((T - corner[:, None]) >> 1),
                              0, maxv)
        is_ver = modes == VER
        is_hor = modes == HOR
        ang[:, :, 0] = torch.where(is_ver[:, None], ver_col, ang[:, :, 0])
        ang[:, 0, :] = torch.where(is_hor[:, None], hor_row, ang[:, 0, :])

    out = torch.where((modes == PLANAR)[:, None, None], pl,
                      torch.where((modes == DC)[:, None, None], dcp, ang))
    return out


def predict_one_mode(r, mode, n, *, component="luma", bit_depth=8):
    """Predict one block: r [4n+1] substituted refs (already filtered
    appropriately by the caller — see select_filtered), mode: int or 0-d
    tensor. Returns [n, n] int32."""
    modes = torch.as_tensor(mode, device=r.device).reshape(1)
    return predict_selected_modes(r[None], modes, n, component=component,
                                  bit_depth=bit_depth)[0]


def select_filtered(r, rf, mode, n):
    """Choose filtered vs unfiltered refs for one mode (luma)."""
    mode = torch.as_tensor(mode, device=r.device).to(torch.int64)
    return torch.where(_filter_mask_t(n, r.device)[mode], rf, r)


def select_filtered_batch(r, rf, modes, n):
    """Per-block filtered/unfiltered ref choice for modes [B]."""
    sel = _filter_mask_t(n, r.device)[modes.to(torch.int64)]
    return torch.where(sel[:, None], rf, r)
