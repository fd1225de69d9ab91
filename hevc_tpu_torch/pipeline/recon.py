"""Wavefront reconstruction (phase B of the AI pipeline).

`encode_frame_planes_batched` is the entry point: the normative
reconstruction + quantized coefficients of a batch of frames. Tensors on a
CUDA device go to the hand-written kernel (`pipeline/recon_kernel.py`,
`csrc/recon_frame.cu`) or raise; tensors on the CPU go to the plain
PyTorch version below, `encode_frame_planes_plain`, frame by frame. There
is no fallback from the kernel to the plain version on the card.

The plain version computes the normative reconstruction + quantized
coefficients for a whole frame on the device of its inputs. Intra prediction needs reconstructed neighbours, which
serializes CTUs along raster order — the formulation is the WPP-style
wavefront: CTUs on the anti-diagonal d = ctu_x + 2*ctu_y are independent
(left, above and above-right neighbours all lie on earlier diagonals), so
each diagonal's CTUs ("lanes") are coded together, batched in one leading
dimension.

The decisions (depth8 / modes4 / nxn8) are on the host before the
reconstruction starts, so the schedule is built there: only TUs that are
leaves are coded at all (the original masks the write-back of the others,
so the result is identical), and inside a CTU the TUs are levelled — a
TU's level is one more than the highest level among the TUs its available
reference samples lie in — so that all TUs of one level and one size, over
all lanes of the diagonal (and over Cb and Cr), run as ONE batch of
predict -> DCT -> quant -> dequant -> IDCT -> reconstruct. This is plain
PyTorch, a chain of small operations per batch.

Parity oracle: the sequential NumPy golden encoder of the reference
package (held equal by the tests).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import intra, quant, rdoq as rdoq_lib, refs, transforms
from . import recon_kernel
from .recon_kernel import node_table


#: batches coded by `_code_tus` since import (plain integer; a run that
#: wants the count of one frame zeroes it and reads it back)
batches = 0


class FramePlanes(NamedTuple):
    recon_y: torch.Tensor     # [pad_h, pad_w] uint8 (batched: leading F)
    recon_cb: torch.Tensor
    recon_cr: torch.Tensor
    coef_y: torch.Tensor      # [pad_h, pad_w] int16 (batched: leading F)
    coef_cb: torch.Tensor
    coef_cr: torch.Tensor


def _levelled(tus, cells):
    """tus: [(x0, y0, n)] in coding order, in units of 4-sample cells of
    a tile `cells` wide. Returns the level of each TU: 1 + the highest
    level among already-coded cells of its left column (2n), corner and
    top row (2n). Cells outside the tile, or not coded yet, count 0: they
    belong to earlier diagonals or are unavailable."""
    lev = np.zeros((2 * cells + 2, 2 * cells + 2), np.int32)  # cell c at [c+1]
    out = []
    for (cx, cy, m) in tus:
        lv = 1 + max(int(lev[cy:cy + 1 + 2 * m, cx].max()),
                     int(lev[cy, cx:cx + 1 + 2 * m].max()))
        lev[cy + 1:cy + 1 + m, cx + 1:cx + 1 + m] = lv
        out.append(lv)
    return out


@functools.lru_cache(maxsize=4096)
def _ctu_steps(depth_key: bytes, nxn_key: bytes):
    """Leaf TUs of one CTU and their levels, from its decision tiles
    (depth8 [8, 8] int8 with -1 outside the frame, nxn8 [8, 8] bool, as
    bytes so that equal CTUs share the work).

    Returns (luma, chroma): int32 arrays [k, 7] of (x0, y0, n, use_dst,
    mx, my, level): TB origin and size in component samples relative to
    the CTU, the luma position whose modes4 entry is the TB's mode (the
    CU's PU0, or the TB's own PU under NxN), and the level, in coding
    order. Luma: 32x32 TUs under a 64 CU, one TU per 32/16/8 CU, four 4x4
    DST TUs under an NxN 8x8 CU. Chroma (per component): four 16x16 TBs
    under a 64 CU, else one TB of half the CU size."""
    depth8 = np.frombuffer(depth_key, np.int8).reshape(8, 8)
    nxn8 = np.frombuffer(nxn_key, np.bool_).reshape(8, 8)
    luma, chroma = [], []
    for (d, x0, y0) in node_table():
        d, x0, y0 = int(d), int(x0), int(y0)
        if depth8[y0 >> 3, x0 >> 3] != d:
            continue
        size = 64 >> d
        if size == 64:
            for (dx, dy) in ((0, 0), (32, 0), (0, 32), (32, 32)):
                luma.append((x0 + dx, y0 + dy, 32, 0, x0, y0))
            for (dx, dy) in ((0, 0), (16, 0), (0, 16), (16, 16)):
                chroma.append(((x0 >> 1) + dx, (y0 >> 1) + dy, 16, 0,
                               x0, y0))
            continue
        if size == 8 and nxn8[y0 >> 3, x0 >> 3]:
            for (dx, dy) in ((0, 0), (4, 0), (0, 4), (4, 4)):
                luma.append((x0 + dx, y0 + dy, 4, 1, x0 + dx, y0 + dy))
        else:
            luma.append((x0, y0, size, 0, x0, y0))
        chroma.append((x0 >> 1, y0 >> 1, size >> 1, 0, x0, y0))

    def pack(tus, cells):
        if not tus:
            return np.zeros((0, 7), np.int32)
        lv = _levelled([(t[0] >> 2, t[1] >> 2, t[2] >> 2) for t in tus],
                       cells)
        return np.array([t + (l,) for t, l in zip(tus, lv)], np.int32)

    return pack(luma, 16), pack(chroma, 8)


def _code_tus(rec, coef, orig, plane, origins, modes, n, *, component, qp,
              rdoq, use_dst, pad_w, pad_h, n_ctu_x, scale):
    """Code a batch of mutually independent leaf TBs of size n, in place.

    rec:  [P, Hp, Wp] int32 reconstruction planes with a 1-sample border
          on the top and left (sample (x, y) at [y+1, x+1]) and slack on
          the bottom and right; coef / orig: [P, H, W] int32.
    plane: [N] int64 plane index of each TB (Cb = 0 / Cr = 1; luma 0);
    origins: [N, 2] int64 (x0, y0) in component samples; modes: [N].
    pad_w / pad_h: coded frame size in component samples (availability)."""
    global batches
    batches += 1
    P, Hp, Wp = rec.shape
    _, H, W = orig.shape
    dx, dy = refs._ref_offsets_t(n, rec.device)
    # reference samples from the reconstruction so far; what is read
    # outside the coded area is unavailable and substituted
    gx = torch.clamp(origins[:, 0:1] + dx + 1, 0, Wp - 1)
    gy = torch.clamp(origins[:, 1:2] + dy + 1, 0, Hp - 1)
    r = rec.reshape(-1)[plane[:, None] * (Hp * Wp) + gy * Wp + gx]
    avail = refs.availability(origins, n, pad_w, pad_h, n_ctu_x, scale)
    r = intra.substitute_refs(r, avail)
    if component == "luma":
        r = intra.select_filtered_batch(r, intra.filter_refs(r), modes, n)
    pred = intra.predict_selected_modes(r, modes, n, component=component)

    ar = torch.arange(n, device=rec.device)
    ys = origins[:, 1:2, None] + ar[None, :, None]            # [N, n, 1]
    xs = origins[:, 0:1, None] + ar[None, None, :]            # [N, 1, n]
    at = plane[:, None, None] * (H * W) + ys * W + xs
    resi = orig.reshape(-1)[at] - pred
    cf = transforms.forward_transform(resi, use_dst=use_dst)
    if rdoq:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        lvl = rdoq_lib.rd_quantize(cf, qp, lam, is_luma=component == "luma")
    else:
        lvl = quant.quantize(cf, qp)
    rresi = transforms.inverse_transform(quant.dequantize(lvl, qp),
                                         use_dst=use_dst)
    out = torch.clamp(pred + rresi, 0, 255)
    # the TBs of one batch are disjoint: plain indexed stores
    coef.reshape(-1)[at] = lvl
    rec.reshape(-1)[plane[:, None, None] * (Hp * Wp)
                    + (ys + 1) * Wp + (xs + 1)] = out


def code_ctu(state, lanes, depth8, modes4, nxn8, *, qp, cqp, pad_w, pad_h,
             n_ctu_x, rdoq=True):
    """Code the CTUs `lanes` = [(ctu_x, ctu_y), ...] in place. The lanes
    must be mutually independent (one CTU, or one wavefront diagonal).

    state: dict of the device planes made by `encode_frame_planes_plain`
    (rec_y/coef_y/orig_y [1, ..], rec_c/coef_c/orig_c [2, ..] = Cb, Cr).
    depth8 / modes4 / nxn8: host arrays, CTU-aligned (depth8 = -1 outside
    the coded frame)."""
    luma, chroma = [], []
    for (cx, cy) in lanes:
        d8 = np.ascontiguousarray(depth8[cy * 8:cy * 8 + 8,
                                         cx * 8:cx * 8 + 8], np.int8)
        n8 = np.ascontiguousarray(nxn8[cy * 8:cy * 8 + 8,
                                       cx * 8:cx * 8 + 8], np.bool_)
        lu, ch = _ctu_steps(d8.tobytes(), n8.tobytes())
        for tus, dst, s in ((lu, luma, 64), (ch, chroma, 32)):
            if len(tus):
                t = tus.copy()
                t[:, 0] += cx * s
                t[:, 1] += cy * s
                t[:, 4] += cx * 64
                t[:, 5] += cy * 64
                dst.append(t)

    device = state["rec_y"].device
    for tus, comp in ((luma, "luma"), (chroma, "chroma")):
        if not tus:
            continue
        t = np.concatenate(tus)
        sc = 1 if comp == "luma" else 2
        mode = modes4[t[:, 5] >> 2, t[:, 4] >> 2]
        # batches: by level, then size (DST 4x4 only occurs at n == 4 luma)
        key = t[:, 6] * 64 + t[:, 2]
        order = np.argsort(key, kind="stable")
        t, mode, key = t[order], mode[order], key[order]
        if comp == "chroma":        # every chroma TB once for Cb, once for Cr
            t = np.repeat(t, 2, axis=0)
            mode = np.repeat(mode, 2)
            key = np.repeat(key, 2)
            plane = np.tile(np.arange(2), len(t) // 2)
        else:
            plane = np.zeros(len(t), np.int64)
        host = np.stack([t[:, 0], t[:, 1], mode, plane], 1).astype(np.int64)
        dev = torch.as_tensor(host).to(device)
        bounds = np.flatnonzero(np.diff(key)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(key)]])
        sfx = "y" if comp == "luma" else "c"
        for a, b in zip(starts, ends):
            n = int(t[a, 2])
            _code_tus(state["rec_" + sfx], state["coef_" + sfx],
                      state["orig_" + sfx], dev[a:b, 3], dev[a:b, 0:2],
                      dev[a:b, 2], n, component=comp,
                      qp=qp if comp == "luma" else cqp, rdoq=rdoq,
                      use_dst=bool(t[a, 3]),
                      pad_w=pad_w // sc, pad_h=pad_h // sc,
                      n_ctu_x=n_ctu_x, scale=sc)


@functools.lru_cache(maxsize=None)
def _diag_lanes(nx, ny):
    """Wavefront schedule: per anti-diagonal d = x + 2y the list of its
    CTUs (ctu_x, ctu_y)."""
    n_diag = (nx - 1) + 2 * (ny - 1) + 1
    return tuple(tuple((d - 2 * cy, cy) for cy in range(ny)
                       if 0 <= d - 2 * cy < nx) for d in range(n_diag))


def encode_frame_planes_plain(orig_y, orig_cb, orig_cr, depth8, modes4,
                              nxn8, *, qp: int, pad_w: int, pad_h: int,
                              rdoq: bool = True, device=None) -> FramePlanes:
    """Whole-frame normative reconstruction + coefficients, plain PyTorch:
    the version the CPU runs, and the one the kernel is held equal to.

    orig_*: [pad_h, pad_w] (chroma half size) uint8/int arrays or tensors.
    depth8: [pad_h/8, pad_w/8] CU depths; modes4: [pad_h/4, pad_w/4]
    per-4x4 luma modes (the PU modes; for 2Nx2N CUs each 4x4 carries the CU
    mode); nxn8: [pad_h/8, pad_w/8] bool NxN part flags at depth-3 CUs —
    host arrays (the schedule is built from them).

    pad_w/pad_h are the coded (min-CU-aligned) dims; internally everything
    is CTU-aligned — boundary CTUs extend past the frame, their outside
    nodes are never leaves (depth8 is padded with -1), and availability
    uses the true pad_w/pad_h. device=None means the card.
    """
    device = resolve_device(device)
    nx, ny = -(-pad_w // 64), -(-pad_h // 64)
    W64, H64 = nx * 64, ny * 64
    cqp = quant.chroma_qp(qp)

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    def pad_np(a, th, tw, value=0):
        a = host(a)
        return np.pad(a, ((0, th - a.shape[0]), (0, tw - a.shape[1])),
                      constant_values=value)

    def plane_t(planes, th, tw):
        out = torch.zeros((len(planes), th, tw), dtype=torch.int32,
                          device=device)
        for i, p in enumerate(planes):
            p = torch.as_tensor(p).to(device)
            out[i, :p.shape[0], :p.shape[1]] = p
        return out

    depth8 = pad_np(depth8, H64 // 8, W64 // 8, value=-1).astype(np.int8)
    modes4 = pad_np(modes4, H64 // 4, W64 // 4).astype(np.int64)
    nxn8 = pad_np(nxn8, H64 // 8, W64 // 8).astype(bool)

    # Recon planes live PRE-PADDED (1-sample top/left border + tile
    # bottom/right slack) so every context read stays inside the array.
    zeros = lambda p, h, w: torch.zeros((p, h, w), dtype=torch.int32,
                                        device=device)
    state = dict(
        orig_y=plane_t([orig_y], H64, W64),
        orig_c=plane_t([orig_cb, orig_cr], H64 // 2, W64 // 2),
        rec_y=zeros(1, H64 + 65, W64 + 65),
        rec_c=zeros(2, H64 // 2 + 33, W64 // 2 + 33),
        coef_y=zeros(1, H64, W64),
        coef_c=zeros(2, H64 // 2, W64 // 2),
    )
    for lanes in _diag_lanes(nx, ny):
        code_ctu(state, lanes, depth8, modes4, nxn8, qp=qp, cqp=cqp,
                 pad_w=pad_w, pad_h=pad_h, n_ctu_x=nx, rdoq=rdoq)

    # narrow dtypes: recon fits u8, levels fit i16 — halves/quarters the
    # device->host transfer that feeds the host CABAC stage.
    hc, wc = pad_h // 2, pad_w // 2
    ry, rc = state["rec_y"], state["rec_c"]
    cy, cc = state["coef_y"], state["coef_c"]
    return FramePlanes(
        recon_y=ry[0, 1:1 + pad_h, 1:1 + pad_w].to(torch.uint8),
        recon_cb=rc[0, 1:1 + hc, 1:1 + wc].to(torch.uint8),
        recon_cr=rc[1, 1:1 + hc, 1:1 + wc].to(torch.uint8),
        coef_y=cy[0, :pad_h, :pad_w].to(torch.int16),
        coef_cb=cc[0, :hc, :wc].to(torch.int16),
        coef_cr=cc[1, :hc, :wc].to(torch.int16),
    )


def encode_frame_planes_plain_batched(ys, cbs, crs, depth8, modes4, nxn8, *,
                                      qp: int, pad_w: int, pad_h: int,
                                      rdoq: bool = True,
                                      device=None) -> FramePlanes:
    """The plain version over a frame batch: `encode_frame_planes_plain`
    frame after frame, stacked (leading F). The decisions go through the
    host, where the plain version builds its schedule."""
    per_frame = [encode_frame_planes_plain(
        ys[f], cbs[f], crs[f], depth8[f], modes4[f], nxn8[f], qp=qp,
        pad_w=pad_w, pad_h=pad_h, rdoq=rdoq, device=device)
        for f in range(len(ys))]
    return FramePlanes(*(torch.stack(p) for p in zip(*per_frame)))


def encode_frame_planes_batched(ys, cbs, crs, depth8, modes4, nxn8, *,
                                qp: int, pad_w: int, pad_h: int,
                                rdoq: bool = True,
                                device=None) -> FramePlanes:
    """Reconstruction + coefficients of a batch of F frames.

    ys [F, pad_h, pad_w], cbs / crs [F, pad_h/2, pad_w/2] samples; depth8
    [F, pad_h/8, pad_w/8], modes4 [F, pad_h/4, pad_w/4], nxn8 [F, pad_h/8,
    pad_w/8] decisions; arrays or tensors. Returns `FramePlanes` with a
    leading F (recon uint8, levels int16).

    device=None keeps tensors where they are (arrays go to the card);
    otherwise everything is moved to `device` first. What then lies on a
    CUDA device is coded by the kernel, decisions and all staying on the
    device, or raises; what lies on the CPU is coded by the plain version,
    one frame after the other. 8-bit 4:2:0 with the "lite" RDOQ model."""
    if device is None and isinstance(ys, torch.Tensor):
        device = ys.device
    device = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    if torch.as_tensor(ys).dim() != 3:
        raise ValueError("encode_frame_planes_batched takes [F, H, W] planes")
    if device.type == "cuda":
        return FramePlanes(*recon_kernel.encode_frame_planes_cuda(
            t(ys, torch.uint8), t(cbs, torch.uint8), t(crs, torch.uint8),
            t(depth8, torch.int32), t(modes4, torch.int32),
            t(nxn8, torch.bool), qp=qp, pad_w=pad_w, pad_h=pad_h, rdoq=rdoq))
    return encode_frame_planes_plain_batched(
        ys, cbs, crs, depth8, modes4, nxn8, qp=qp, pad_w=pad_w, pad_h=pad_h,
        rdoq=rdoq, device=device)
