"""Batched reference-sample machinery for the device pipeline.

Gathers the linear intra reference array r[0..4n] for many blocks at once
from a frame plane, and computes normative availability (H.265 6.4.1)
fully vectorized: global z-scan addresses are Morton codes computed with
bit ops — no tables, no host round-trips. Shared by the mode-search phase
(original-pixel references) and the reconstruction phase.

Coordinates are int64 tensors (PyTorch indexes with int64); sample values
are int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _interleave4(v):
    """Spread the low 4 bits of v: abcd -> a0b0c0d0 (vectorized)."""
    v = v & 0xF
    v = (v | (v << 2)) & 0x33
    v = (v | (v << 1)) & 0x55
    return v


def zaddr(gx, gy, n_ctu_x):
    """Global decode-order address of the 4x4 block containing (gx, gy)
    (luma sample coords). Higher = later in decode order."""
    bx = gx >> 2
    by = gy >> 2
    cx = bx >> 4
    cy = by >> 4
    morton = _interleave4(bx & 15) | (_interleave4(by & 15) << 1)
    return (cy * n_ctu_x + cx) * 256 + morton


@functools.lru_cache(maxsize=None)
def ref_offsets(n: int):
    """Static (dx, dy) of each linear ref sample relative to block origin.

    Layout (ops.intra): r[i] = p[-1][2n-1-i] for i<2n (left, bottom-up),
    r[2n] = corner, r[2n+1+i] = p[i][-1] (top).
    """
    dx = np.empty(4 * n + 1, np.int64)
    dy = np.empty(4 * n + 1, np.int64)
    i = np.arange(2 * n)
    dx[:2 * n] = -1
    dy[:2 * n] = 2 * n - 1 - i
    dx[2 * n] = -1
    dy[2 * n] = -1
    dx[2 * n + 1:] = i
    dy[2 * n + 1:] = -1
    return dx, dy


@functools.lru_cache(maxsize=None)
def _ref_offsets_t(n: int, device):
    dx, dy = ref_offsets(n)
    return (torch.as_tensor(dx, device=device)[None, :],
            torch.as_tensor(dy, device=device)[None, :])


def gather_refs(plane, origins, n: int, frame=None):
    """Gather linear refs for B blocks.

    plane: [H, W] integer tensor, or a frame batch [F, H, W] with `frame`
    [B] int64 naming each block's frame; origins: [B, 2] int64 (x0, y0) in
    plane coords. Returns [B, 4n+1] int32 (clamped reads; pair with
    availability()).
    """
    h, w = plane.shape[-2:]
    dx, dy = _ref_offsets_t(n, plane.device)
    gx = torch.clamp(origins[:, 0:1] + dx, 0, w - 1)
    gy = torch.clamp(origins[:, 1:2] + dy, 0, h - 1)
    at = gy * w + gx
    if frame is not None:
        at = at + frame[:, None] * (h * w)
    return plane.reshape(-1)[at].to(torch.int32)


def availability(origins, n: int, pad_w: int, pad_h: int, n_ctu_x: int,
                 scale: int = 1):
    """Normative availability of each linear ref sample.

    origins: [B, 2] int64 block (x0, y0) in component coords; scale=2 for
    4:2:0 chroma (z-addresses are evaluated at co-located luma positions).
    pad_w/pad_h in component units.
    """
    dx, dy = _ref_offsets_t(n, origins.device)
    gx = origins[:, 0:1] + dx
    gy = origins[:, 1:2] + dy
    inside = (gx >= 0) & (gy >= 0) & (gx < pad_w) & (gy < pad_h)
    cur = zaddr(origins[:, 0:1] * scale, origins[:, 1:2] * scale, n_ctu_x)
    ref = zaddr(torch.clamp(gx, min=0) * scale,
                torch.clamp(gy, min=0) * scale, n_ctu_x)
    return inside & (ref < cur)


def prepare_refs(plane, origins, n: int, pad_w: int, pad_h: int,
                 n_ctu_x: int, scale: int = 1, bit_depth: int = 8,
                 frame=None):
    """gather + availability + substitution in one call -> [B, 4n+1]."""
    from . import intra
    r = gather_refs(plane, origins, n, frame)
    av = availability(origins, n, pad_w, pad_h, n_ctu_x, scale)
    return intra.substitute_refs(r, av, bit_depth)
