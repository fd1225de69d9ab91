"""Distortion metrics: SAD, SSE, Hadamard SATD (8x8 / 4x4).

Behavioral reference: HM TComRdCost.cpp (SAD/SSE/xCalcHADs8x8); HM computes
SATD over 8x8 Hadamard blocks with the final sum scaled per block
(and 4x4 for small partitions). Used by intra RMD mode preselection.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def sad(a, b, axes=(-2, -1)):
    return (a.to(torch.int32) - b.to(torch.int32)).abs().sum(axes)


def sse(a, b, axes=(-2, -1)):
    d = a.to(torch.int32) - b.to(torch.int32)
    return (d * d).sum(axes)


@functools.lru_cache(maxsize=None)
def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


@functools.lru_cache(maxsize=None)
def _hadamard_t(n: int, device):
    return torch.as_tensor(_hadamard(n), dtype=torch.float32, device=device)


def satd(a, b, block: int = 8):
    """Sum of absolute Hadamard-transformed differences.

    a, b: [..., H, W] with H, W multiples of `block`.
    Returns [...] int32 totals, HM-scaled per k x k Hadamard block:
    8x8: (sum + 2) >> 2, 4x4: (sum + 1) >> 1, rounded per block before
    the sum over blocks.

    The two-sided Hadamard runs as float32 products (TF32 is off
    package-wide): for 8-bit samples every partial sum is an integer of
    magnitude <= 255 * k * k < 2^24, so the result is the integer one.
    """
    d = a.to(torch.int32) - b.to(torch.int32)
    *lead, H, W = d.shape
    k = block
    h = _hadamard_t(k, d.device)
    d = d.reshape(*lead, H // k, k, W // k, k)
    d = d.movedim(-3, -2).to(torch.float32)  # [..., H/k, W/k, k, k]
    t = torch.matmul(torch.matmul(h, d), h)
    s = t.abs().sum((-2, -1)).to(torch.int32)
    if k == 8:
        s = (s + 2) >> 2
    else:
        s = (s + 1) >> 1
    return s.sum((-2, -1), dtype=torch.int32)


def satd_np(a, b, block: int = 8):
    """NumPy twin of `satd` (int64, exact): the golden encoder's mode
    decision on the host."""
    d = np.asarray(a, np.int64) - np.asarray(b, np.int64)
    *lead, H, W = d.shape
    k = block
    h = _hadamard(k).astype(np.int64)
    d = d.reshape(*lead, H // k, k, W // k, k)
    d = np.moveaxis(d, -3, -2)
    t = np.einsum("ij,...jk,kl->...il", h, d, h)
    s = np.abs(t).sum((-2, -1))
    s = ((s + 2) >> 2) if k == 8 else ((s + 1) >> 1)
    return s.sum((-2, -1)).astype(np.int64)
