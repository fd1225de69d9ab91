"""Normative motion-vector derivation for the decoder's P/B parser.

Multi-reference uni-L0 toolset (low-delay P / GPB low-delay B with
identical lists): merge candidate list (8.5.3.2.2-5) and the
two-candidate AMVP list (8.5.3.2.6-8) over a motion field of (mv,
refIdx) per 8x8 unit, with the normative POC-distance MV scaling. All
reference pictures are past short-term pictures, so td/tb > 0.

In a B slice the zero merging candidates are bi-predictive (8.5.3.2.5):
they are returned as 4-tuples (0, 0, refIdxL0, refIdxL1), which no
uni-L0 motion equals. The encoder never selects them, so the motion
field stays uni-L0 and no combined bi-predictive candidate (8.5.3.2.4,
which needs a neighbour with L1 motion) can arise.

Behavioral counterparts: TComDataCU::getInterMergeCandidates /
fillMvpCand, TComSlice POC distance scaling (HM TComDataCU.cpp).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

Motion = Tuple[int, int, int]          # (mvx, mvy, refIdx)


def _clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v


def scale_mv(mv: Tuple[int, int], tb: int, td: int) -> Tuple[int, int]:
    """POC-distance MV scaling (8.5.3.2.8). tb = cur->target ref
    distance, td = cur->neighbour ref distance (both nonzero)."""
    if tb == td:
        return mv
    td = _clip3(-128, 127, td)
    tb = _clip3(-128, 127, tb)
    tx = (16384 + (abs(td) >> 1)) // td
    dsf = _clip3(-4096, 4095, (tb * tx + 32) >> 6)

    def s(c):
        p = dsf * c
        return _clip3(-32768, 32767,
                      (abs(p) + 127) >> 8 if p >= 0
                      else -((abs(p) + 127) >> 8))

    return (s(mv[0]), s(mv[1]))


class MotionField:
    """(mv, refIdx) per 8x8 unit + availability, for one picture."""

    def __init__(self, mvq8: np.ndarray, ref8: Optional[np.ndarray],
                 pad_w: int, pad_h: int, zmap: np.ndarray,
                 inter8: Optional[np.ndarray] = None):
        self.mvq8 = mvq8
        self.ref8 = ref8          # None == all refIdx 0
        self.inter8 = inter8      # None == every unit inter-coded
        self.W = pad_w
        self.H = pad_h
        self.zmap = zmap

    def at(self, xn: int, yn: int, cur_z: int) -> Optional[Motion]:
        """Motion at luma position (xn, yn) if available in z-scan order
        and inter-coded (6.4.1), else None."""
        if xn < 0 or yn < 0 or xn >= self.W or yn >= self.H:
            return None
        if self.zmap[yn >> 2, xn >> 2] >= cur_z:
            return None
        if self.inter8 is not None and not self.inter8[yn >> 3, xn >> 3]:
            return None
        r = 0 if self.ref8 is None else int(self.ref8[yn >> 3, xn >> 3])
        return (int(self.mvq8[yn >> 3, xn >> 3, 0]),
                int(self.mvq8[yn >> 3, xn >> 3, 1]), r)


def _pu_aware_at(field: MotionField, cur_z: int, x0: int, y0: int,
                 size: int, part_mode: int, part_idx: int):
    """Neighbour-motion lookup with the same-CB PartIdx availability of
    6.4.2: for the second PU of a rectangular partition, positions inside
    the FIRST PU of the same CB are available (PU0 precedes PU1 in
    decoding order) even though their 4x4 z-scan address exceeds the
    current PB's — the plain z-map test would wrongly reject them (HM
    getPULeft/getPUAbove return the own CU's PU0 without a z check).

    (x0, y0) here are the PU coordinates; the CB origin is derived from
    the partition geometry. part_idx 0 never probes its own CB, so the
    plain lookup falls through."""
    if part_idx != 1 or part_mode == 0:
        return lambda xn, yn: field.at(xn, yn, cur_z)
    cx0 = x0 - (size >> 1) if part_mode == 2 else x0
    cy0 = y0 - (size >> 1) if part_mode == 1 else y0

    def at(xn, yn):
        if cx0 <= xn < cx0 + size and cy0 <= yn < cy0 + size:
            in_pu0 = ((yn < cy0 + (size >> 1)) if part_mode == 1
                      else (xn < cx0 + (size >> 1)))
            if not in_pu0:
                return None
            r = (0 if field.ref8 is None
                 else int(field.ref8[yn >> 3, xn >> 3]))
            return (int(field.mvq8[yn >> 3, xn >> 3, 0]),
                    int(field.mvq8[yn >> 3, xn >> 3, 1]), r)
        return field.at(xn, yn, cur_z)

    return at


def merge_candidates(field: MotionField, x0: int, y0: int, size: int,
                     n_active_refs: int = 1,
                     max_cands: int = 5, w: int = None, h: int = None,
                     part_mode: int = 0, part_idx: int = 0,
                     is_b: bool = False) -> List[tuple]:
    """Merge candidate list (8.5.3.2.2), uni-L0 neighbours, TMVP off.

    Spatial A1 B1 B0 A0 (+B2 if fewer than 4) with normative pruning on
    full motion (mv AND refIdx), then zero-MV candidates iterating
    refIdx 0..n_active_refs-1 (the zeroIdx rule). is_b: a B slice,
    whose zero candidates are bi-predictive (0, 0, refIdx, refIdx).

    Rectangular PUs (x0/y0/w/h = the PU): per 8.5.3.2.3 the second PU
    excludes the candidate inside the first PU — A1 unavailable for
    PartIdx 1 of Nx2N (part_mode 2), B1 unavailable for PartIdx 1 of
    2NxN (part_mode 1) — so merging can never reproduce 2Nx2N motion.
    """
    w = size if w is None else w
    h = size if h is None else h
    cur_z = field.zmap[y0 >> 2, x0 >> 2]
    at = _pu_aware_at(field, cur_z, x0, y0, size, part_mode, part_idx)

    a1 = (None if (part_idx == 1 and part_mode == 2)
          else at(x0 - 1, y0 + h - 1))
    b1 = (None if (part_idx == 1 and part_mode == 1)
          else at(x0 + w - 1, y0 - 1))
    b0 = at(x0 + w, y0 - 1)
    a0 = at(x0 - 1, y0 + h)
    cands: List[Motion] = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and b1 != a1:
        cands.append(b1)
    if b0 is not None and b0 != b1:
        cands.append(b0)
    if a0 is not None and a0 != a1:
        cands.append(a0)
    if len(cands) < 4:
        b2 = at(x0 - 1, y0 - 1)
        if b2 is not None and b2 != a1 and b2 != b1:
            cands.append(b2)
    zero_idx = 0
    while len(cands) < max_cands:
        r = zero_idx if zero_idx < n_active_refs else 0
        cands.append((0, 0, r, r) if is_b else (0, 0, r))
        zero_idx += 1
    return cands[:max_cands]


def amvp_candidates(field: MotionField, x0: int, y0: int, w: int, h: int,
                    target_ref: int, ref_pocs: Sequence[int],
                    cur_poc: int, cu_size: int = 0, part_mode: int = 0,
                    part_idx: int = 0) -> List[Tuple[int, int]]:
    """Two-entry AMVP candidate list (8.5.3.2.6-8), uni-L0, TMVP off.

    ref_pocs[r] = POC of reference index r in RefPicList0. Candidate A
    scans A0, A1 (same-ref first, then POC-scaled); candidate B scans
    B0, B1, B2 same-ref, and is only scaled when no A neighbour exists
    (isScaledFlag rule). Pruned and zero-padded to exactly 2.

    cu_size/part_mode/part_idx: rectangular-PU context — same-CB PU0
    positions are available to PU1 (6.4.2), see _pu_aware_at."""
    cur_z = field.zmap[y0 >> 2, x0 >> 2]
    at = _pu_aware_at(field, cur_z, x0, y0, cu_size or max(w, h),
                      part_mode, part_idx)
    tgt_poc = ref_pocs[target_ref]

    a_pos = ((x0 - 1, y0 + h), (x0 - 1, y0 + h - 1))       # A0, A1
    b_pos = ((x0 + w, y0 - 1), (x0 + w - 1, y0 - 1),
             (x0 - 1, y0 - 1))                              # B0, B1, B2

    def same_ref_scan(positions):
        for (xn, yn) in positions:
            m = at(xn, yn)
            if m is not None and ref_pocs[m[2]] == tgt_poc:
                return (m[0], m[1])
        return None

    def scaled_scan(positions):
        for (xn, yn) in positions:
            m = at(xn, yn)
            if m is not None:
                tb = cur_poc - tgt_poc
                td = cur_poc - ref_pocs[m[2]]
                return scale_mv((m[0], m[1]), tb, td)
        return None

    # isScaledFlagLX (step 1): any A neighbour available
    is_scaled = any(at(xn, yn) is not None for (xn, yn) in a_pos)

    # candidate A: same-ref scan, then scaled scan (steps 2-3)
    mv_a = same_ref_scan(a_pos)
    if mv_a is None and is_scaled:
        mv_a = scaled_scan(a_pos)

    # candidate B: same-ref scan (step 4)
    mv_b = same_ref_scan(b_pos)

    if not is_scaled:
        # steps 5-6: B is promoted into the A slot, then B re-derived
        # by the scaled scan (which may re-pick the same neighbour and
        # be pruned below)
        mv_a = mv_b
        mv_b = scaled_scan(b_pos)

    # step 7 pruning + zero padding
    cands: List[Tuple[int, int]] = []
    if mv_a is not None:
        cands.append(mv_a)
    if mv_b is not None and mv_b != mv_a:
        cands.append(mv_b)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands[:2]
