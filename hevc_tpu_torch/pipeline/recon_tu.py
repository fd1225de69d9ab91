"""TU-granular wavefront reconstruction (the `"tu"` reconstruction backend
of `pipeline/ai.AIEncoder` and `parallel/frames.FrameParallelAI`).

The CTU-diagonal engine (pipeline/recon.py) walks 62 diagonals of CTUs at
1080p. Intra dependencies actually live at TU granularity, so this
backend schedules *every TU of the frame* into dependency levels (a
host-side longest path over the reference-sample DAG, in NumPy) and
runs one step per level (several hundred levels at 1080p), each a batched
gather -> predict -> DCT -> quant -> IDCT -> reconstruct -> scatter over
all TUs of the level, grouped by size class (32 / 16 / 8). Same normative
maths as pipeline/recon.py (the shared ops); held equal to the golden
encoder.

The reference runs this as plain XLA (no Pallas kernel), so it is plain
PyTorch on the device here: a long chain of small operations, bound by
their launches on the card. Two traits of the reference are kept:
- the levels are padded to a bucket of 16 steps and each size class's
  lanes to a power of two (`build_schedule`); lanes that are not active
  are computed and then written to a scratch row past the planes (the
  reference drops them with an out-of-range scatter index). A step in
  which a size class has no active lane at all is skipped on the host,
  which changes no sample;
- RDOQ is always on (`RDOQ_ON`), whatever `cfg.rdoq` says; the levels it
  chooses are legal, and HM decodes them.

NxN is not coded: a TU equals its CU (the four 32x32 TUs of a 64x64 CU
excepted), so the decide step of this backend runs with NxN off.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops import intra, quant, rdoq as rdoq_lib, refs, transforms
from .recon import FramePlanes

RDOQ_ON = True  # the reference's constant: cfg.rdoq is not read here

#: samples of the scratch row the inactive lanes write to (one 32x32 TU)
_SCRATCH = 32 * 32


# ---------------------------------------------------------------------------
# Host-side schedule
# ---------------------------------------------------------------------------

def _leaf_tus(depth8):
    """Enumerate luma TUs in coding order: (u0, v0, s8) in 8-px cells.

    64-CUs emit their four 32x32 TUs (implicit split); smaller CUs emit
    TU == CU.
    """
    h8, w8 = depth8.shape
    tus = []

    def rec(u, v, size8, depth):
        if u >= w8 or v >= h8:
            return
        d = depth8[v, u]
        if d > depth or (u + size8 > w8) or (v + size8 > h8):
            h = size8 // 2
            for (du, dv) in ((0, 0), (h, 0), (0, h), (h, h)):
                rec(u + du, v + dv, h, depth + 1)
        else:
            if size8 == 8:
                for (du, dv) in ((0, 0), (4, 0), (0, 4), (4, 4)):
                    tus.append((u + du, v + dv, 4))
            else:
                tus.append((u, v, size8))

    for cv in range(0, h8, 8):
        for cu in range(0, w8, 8):
            rec(cu, cv, 8, 0)
    return tus


def build_schedule(depth8):
    """Assign each TU a dependency level; group by (level, size class).

    Returns dict size8 -> (idx [n_steps, cap, 2] int32, act [n_steps, cap]
    bool) plus n_steps. Levels: level(TU) = 1 + max(level of coded cells
    its reference samples touch).
    """
    depth8 = np.asarray(depth8)
    h8, w8 = depth8.shape
    tus = _leaf_tus(depth8)
    level_map = np.full((h8, w8), -1, np.int32)
    levels = []
    for (u, v, s8) in tus:
        lv = 0
        # left column cells (incl. below-left) and top row (incl. top-right)
        if u > 0:
            vv = slice(v, min(v + 2 * s8, h8))
            cells = level_map[vv, u - 1]
            if cells.size:
                lv = max(lv, int(cells.max()) + 1)
        if v > 0:
            lo = max(u - 1, 0)
            hi = min(u + 2 * s8, w8)
            cells = level_map[v - 1, lo:hi]
            if cells.size:
                lv = max(lv, int(cells.max()) + 1)
        levels.append(lv)
        level_map[v:v + s8, u:u + s8] = lv

    n_steps = max(levels) + 1 if levels else 1
    # pad the step count to a bucket of 16 (the reference bounds its
    # compiled shape variants so)
    n_steps = -(-n_steps // 16) * 16
    out = {}
    for s8 in (1, 2, 4):
        per_level = [[] for _ in range(n_steps)]
        for (tu, lv) in zip(tus, levels):
            if tu[2] == s8:
                per_level[lv].append((tu[0], tu[1]))
        cap = max((len(p) for p in per_level), default=0)
        cap = max(cap, 1)
        # quantize cap to powers of two
        cap = 1 << (cap - 1).bit_length()
        idx = np.zeros((n_steps, cap, 2), np.int32)
        act = np.zeros((n_steps, cap), bool)
        for lv, p in enumerate(per_level):
            for i, (u, v) in enumerate(p):
                idx[lv, i] = (u, v)
                act[lv, i] = True
        out[s8] = (idx, act)
    return out, n_steps


def stack_schedules(schedules):
    """Per-frame schedules (`build_schedule(...)[0]` each) padded to
    common shapes: dict size8 -> (idx [F, n_steps, cap, 2], act [F,
    n_steps, cap]); the padding is inactive lanes."""
    stacked = {}
    for s8 in (1, 2, 4):
        n_steps = max(sc[s8][0].shape[0] for sc in schedules)
        cap = max(sc[s8][0].shape[1] for sc in schedules)
        idx = np.zeros((len(schedules), n_steps, cap, 2), np.int32)
        act = np.zeros((len(schedules), n_steps, cap), bool)
        for i, sc in enumerate(schedules):
            si, sa = sc[s8]
            idx[i, :si.shape[0], :si.shape[1]] = si
            act[i, :sa.shape[0], :sa.shape[1]] = sa
        stacked[s8] = (idx, act)
    return stacked


# ---------------------------------------------------------------------------
# Device compute
# ---------------------------------------------------------------------------

class _Planes:
    """One component's reconstruction and level planes of F frames (Cb
    and Cr together as 2F frames), each flat with the scratch row at the
    end, and its original samples [F, h, w] int32."""

    def __init__(self, orig):
        self.orig = orig
        self.F, self.h, self.w = orig.shape
        size = orig.numel() + _SCRATCH
        self.rec = torch.zeros(size, dtype=torch.int32, device=orig.device)
        self.coef = torch.zeros(size, dtype=torch.int32, device=orig.device)

    def rec_view(self):
        return self.rec[:self.orig.numel()].view(self.F, self.h, self.w)

    def coef_view(self):
        return self.coef[:self.orig.numel()].view(self.F, self.h, self.w)

    def gather_orig(self, org, frame, n):
        """[L, n, n] original samples of each lane's block (clamped)."""
        ar = torch.arange(n, device=org.device)
        ys = torch.clamp(org[:, 1:2, None] + ar[None, :, None], 0, self.h - 1)
        xs = torch.clamp(org[:, 0:1, None] + ar[None, None, :], 0, self.w - 1)
        return self.orig[frame[:, None, None], ys, xs]

    def scatter(self, rec, lvl, org, frame, active, n):
        """Write each active lane's block; inactive lanes go to the
        scratch row."""
        ar = torch.arange(n, device=org.device)
        ys = org[:, 1:2, None] + ar[None, :, None]
        xs = org[:, 0:1, None] + ar[None, None, :]
        at = frame[:, None, None] * (self.h * self.w) + ys * self.w + xs
        scratch = self.orig.numel() + ar[:, None] * n + ar[None, :]
        at = torch.where(active[:, None, None], at, scratch[None]).reshape(-1)
        self.rec[at] = rec.reshape(-1)
        self.coef[at] = lvl.reshape(-1)


def _code_blocks(orig, pred, qp, use_dst, is_luma):
    """predict residual -> transform -> RDOQ -> dequant -> inverse ->
    clip: (levels, reconstruction) of [L, n, n] blocks."""
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    cf = transforms.forward_transform(orig - pred, use_dst=use_dst)
    lvl = (rdoq_lib.rd_quantize(cf, qp, lam, is_luma=is_luma) if RDOQ_ON
           else quant.quantize(cf, qp))
    rres = transforms.inverse_transform(quant.dequantize(lvl, qp),
                                        use_dst=use_dst)
    return lvl, torch.clamp(pred + rres, 0, 255)


def _code_class(luma, chroma, modes8, idx, act, frame, s8, *, qp, cqp,
                pad_w, pad_h, n_ctu_x):
    """Code all lanes of one size class at one level: idx [L, 2] int64 TU
    origins in 8-px cells, act [L] bool, frame [L] int64."""
    n = s8 * 8
    origins = idx * 8                      # luma sample coords [L, 2]
    modes = modes8[frame, idx[:, 1], idx[:, 0]]

    # ---- luma ----
    r = refs.gather_refs(luma.rec_view(), origins, n, frame)
    av = refs.availability(origins, n, pad_w, pad_h, n_ctu_x, 1)
    r = intra.substitute_refs(r, av)
    rf = intra.filter_refs(r)
    pred = intra.predict_selected_modes(
        intra.select_filtered_batch(r, rf, modes, n), modes, n)
    orig = luma.gather_orig(origins, frame, n)
    lvl, rec = _code_blocks(orig, pred, qp, n == 4, True)
    luma.scatter(rec, lvl, origins, frame, act, n)

    # ---- chroma: Cb and Cr as one batch (frames F..2F-1 are Cr). Every
    # luma TU of this backend carries its co-located chroma TB (the four
    # 32-TUs of a 64-CU each carry one 16x16 TB) ----
    cn = n // 2
    corg = torch.cat([origins // 2, origins // 2])
    cframe = torch.cat([frame, frame + luma.F])
    cmodes = torch.cat([modes, modes])
    rc = refs.gather_refs(chroma.rec_view(), corg, cn, cframe)
    avc = refs.availability(corg, cn, pad_w // 2, pad_h // 2, n_ctu_x, 2)
    rc = intra.substitute_refs(rc, avc)
    predc = intra.predict_selected_modes(rc, cmodes, cn, component="chroma")
    origc = chroma.gather_orig(corg, cframe, cn)
    lvlc, recc = _code_blocks(origc, predc, cqp, False, False)
    chroma.scatter(recc, lvlc, corg, cframe, torch.cat([act, act]), cn)


def encode_frame_planes_tu_inner(orig_y, orig_cb, orig_cr, modes8,
                                 s1i, s1a, s2i, s2a, s4i, s4a, *,
                                 qp, pad_w, pad_h):
    """Whole-frame TU-wavefront reconstruction of a frame batch, on the
    device of the planes.

    orig_*: [F, h, w] tensors (any integer type); modes8 [F, pad_h/8,
    pad_w/8]; s{1,2,4}i / s{1,2,4}a: the host schedule arrays of each
    size class with a leading F (`stack_schedules`). Returns FramePlanes
    with a leading F (recon uint8, levels int16)."""
    dev = orig_y.device
    F = orig_y.shape[0]
    nx = -(-pad_w // 64)
    kw = dict(qp=qp, cqp=quant.chroma_qp(qp), pad_w=pad_w, pad_h=pad_h,
              n_ctu_x=nx)
    luma = _Planes(orig_y.to(torch.int32))
    chroma = _Planes(torch.cat([orig_cb, orig_cr]).to(torch.int32))
    modes8 = torch.as_tensor(modes8).to(dev, torch.int64)
    classes = {}
    for s8, (si, sa) in ((1, (s1i, s1a)), (2, (s2i, s2a)), (4, (s4i, s4a))):
        si, sa = np.asarray(si), np.asarray(sa, bool)
        cap = si.shape[2]
        classes[s8] = (si, sa,
                       torch.as_tensor(si, dtype=torch.int64, device=dev),
                       torch.as_tensor(sa, device=dev),
                       torch.arange(F, device=dev).repeat_interleave(cap))
    n_steps = max(c[0].shape[1] for c in classes.values())
    for step in range(n_steps):
        for s8 in (4, 2, 1):
            si, sa, idx, act, frame = classes[s8]
            if step >= sa.shape[1] or not sa[:, step].any():
                continue                 # no active lane: nothing to write
            _code_class(luma, chroma, modes8, idx[:, step].reshape(-1, 2),
                        act[:, step].reshape(-1), frame, s8, **kw)
    cb, cr = chroma.rec_view()[:F], chroma.rec_view()[F:]
    ccb, ccr = chroma.coef_view()[:F], chroma.coef_view()[F:]
    return FramePlanes(
        recon_y=luma.rec_view().to(torch.uint8),
        recon_cb=cb.to(torch.uint8), recon_cr=cr.to(torch.uint8),
        coef_y=luma.coef_view().to(torch.int16),
        coef_cb=ccb.to(torch.int16), coef_cr=ccr.to(torch.int16))


def reconstruct_tu(pf_y, pf_cb, pf_cr, depth8, modes8, *, qp, pad_w, pad_h,
                   device=None):
    """One frame: build its schedule on the host, reconstruct it on the
    device. The planes and maps are host arrays; device=None means the card
    (raises without one). Returns FramePlanes without a frame axis."""
    dev = resolve_device(device)
    sched, _ = build_schedule(np.asarray(depth8))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)[None]

    planes = encode_frame_planes_tu_inner(
        t(pf_y), t(pf_cb), t(pf_cr), t(modes8),
        *(a[None] for s8 in (1, 2, 4) for a in sched[s8]),
        qp=qp, pad_w=pad_w, pad_h=pad_h)
    return FramePlanes(*(p[0] for p in planes))
