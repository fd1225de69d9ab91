"""35-mode intra prediction + Hadamard SATD search, weight-table form.

Every HEVC intra prediction (planar / angular, incl. the VER/HOR edge
smoothing) is an integer-linear function of the boundary reference
samples followed by one floor-shift — so predicting ALL modes for a
node is one product `refs [B, 2R+1] x W [2R+1, 35*n*n]` against a
precomputed integer weight matrix (DC is the lone exception: its
interior value is floored before the edge rows reuse it, so it gets a
tiny vector epilogue).

`satd_all_modes` folds the Hadamard-SATD mode metric (TComRdCost.cpp
xCalcHADs8x8 semantics via ops/cost.satd) over the predicted blocks.
For CUDA tensors it launches the hand-written kernel of
`csrc/satd35.cu`, which forms prediction, difference, Hadamard and the
per-block sums in registers so the 35x prediction blow-up never reaches
device memory; for CPU tensors it runs the plain PyTorch version below
(`satd_all_modes_plain`: `predict_all_modes_mm` + `cost.satd`). There is
no fallback from the kernel to the plain version on the card.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from .. import BUILD_DIR, cuda_build
from . import cost, intra


@functools.lru_cache(maxsize=None)
def _tables(n: int, component: str = "luma", bit_depth: int = 8):
    """Build (W [2R+1, 35*n*n] f32, inv_shift [35*n*n] f32,
    clip_mask [35*n*n] bool) — integer weights over the concatenated
    (unfiltered refs, filtered refs, bias) vector.

    Column layout: mode-major, then y, then x. DC columns are zero
    (handled by the exact epilogue in predict_all_modes_mm)."""
    R = 4 * n + 1
    ncol = 35 * n * n
    W = np.zeros((2 * R + 1, ncol), np.float32)
    shift = np.zeros(ncol, np.int32)
    clip = np.zeros(ncol, bool)
    fmask = np.array([intra.ref_filter_flag(m, n) for m in range(35)],
                     bool)
    log2n = n.bit_length() - 1
    bias_row = 2 * R

    def col(m, y, x):
        return (m * n + y) * n + x

    # r layout (ops/refs): r[2n-1-j] = left[j], r[2n] = corner,
    # r[2n+1+i] = top[i]
    def left_row(j, base):
        return base + 2 * n - 1 - j

    def top_row(i, base):
        return base + 2 * n + 1 + i

    corner_row = lambda base: base + 2 * n

    # planar (mode 0)
    base = R if fmask[0] else 0
    for y in range(n):
        for x in range(n):
            c = col(0, y, x)
            W[left_row(y, base), c] += n - 1 - x
            W[top_row(n, base), c] += x + 1          # top-right
            W[top_row(x, base), c] += n - 1 - y
            W[left_row(n, base), c] += y + 1         # bottom-left
            W[bias_row, c] += n
            shift[c] = log2n + 1

    # angular modes 2..34
    for m in range(2, 35):
        base = R if fmask[m] else 0
        i0, i1, fa = intra._angular_tables(m, n)
        for y in range(n):
            for x in range(n):
                c = col(m, y, x)
                W[base + i0[y, x], c] += 32 - fa[y, x]
                W[base + i1[y, x], c] += fa[y, x]
                W[bias_row, c] += 16
                shift[c] = 5
        if component == "luma" and n < 32:
            if m == intra.VER:
                # pred[y][0] = clip(top[0] + ((left[y]-corner)>>1))
                #            = clip((2*top[0] + left[y] - corner) >> 1)
                for y in range(n):
                    c = col(m, y, 0)
                    W[:, c] = 0.0
                    W[top_row(0, base), c] = 2
                    W[left_row(y, base), c] = 1
                    W[corner_row(base), c] = -1
                    shift[c] = 1
                    clip[c] = True
            elif m == intra.HOR:
                for x in range(n):
                    c = col(m, 0, x)
                    W[:, c] = 0.0
                    W[left_row(0, base), c] = 2
                    W[top_row(x, base), c] = 1
                    W[corner_row(base), c] = -1
                    shift[c] = 1
                    clip[c] = True

    inv_shift = (2.0 ** -shift).astype(np.float32)
    return W, inv_shift, clip


@functools.lru_cache(maxsize=None)
def _tables_t(n, component, bit_depth, device):
    W, inv_shift, clip = _tables(n, component, bit_depth)
    return (torch.as_tensor(W, device=device),
            torch.as_tensor(inv_shift, device=device),
            torch.as_tensor(clip, device=device))


def _dc_block(r_u, n, component, bit_depth):
    """Exact DC prediction [B, n, n] (interior floor + edge smoothing,
    predict_all_modes DC path)."""
    left, top, _ = intra._split(r_u, n)
    return intra._dc(left, top, n, component)


def predict_all_modes_mm(r_u, r_f, n, *, component="luma", bit_depth=8):
    """All 35 modes via one float32 product; bit-exact vs the per-mode-
    selected (filtered/unfiltered) gather formulation:
    where(fmask, predict_all_modes(r_f), predict_all_modes(r_u)).
    Exact because every product and partial sum is an integer below
    2^24 and TF32 is off package-wide.

    r_u/r_f: [B, 4n+1] substituted refs, unfiltered / filtered.
    Returns [B, 35, n, n] int32.
    """
    W, inv_shift, clip = _tables_t(n, component, bit_depth, r_u.device)
    r_u = r_u.to(torch.int32)
    B = r_u.shape[0]
    refs = torch.cat(
        [r_u, r_f.to(torch.int32),
         torch.ones((B, 1), dtype=torch.int32, device=r_u.device)],
        dim=1).to(torch.float32)
    raw = refs @ W
    pred = torch.floor(raw * inv_shift)
    maxv = float((1 << bit_depth) - 1)
    pred = torch.where(clip, torch.clamp(pred, 0.0, maxv), pred)
    pred = pred.to(torch.int32).reshape(B, 35, n, n)
    pred[:, 1] = _dc_block(r_u, n, component, bit_depth)
    return pred


def satd_all_modes_plain(r_u, r_f, orig, n, *, component="luma",
                         bit_depth=8):
    """Plain PyTorch version of `satd_all_modes` (materializes all 35
    predictions). The CPU path, and the yardstick the kernel is held
    equal to on the card."""
    preds = predict_all_modes_mm(r_u, r_f, n, component=component,
                                 bit_depth=bit_depth)
    block = 4 if n == 4 else 8
    return cost.satd(orig.to(torch.int32)[:, None], preds, block=block)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/satd35.cu): build, operand checks, launch.
# ---------------------------------------------------------------------------

#: launches of the CUDA kernel by `satd_all_modes` (plain integer; a run
#: that wants to show the kernel was used zeroes it and reads it back)
launches = 0

_CSRC = os.path.join(cuda_build.CSRC_DIR, "satd35.cu")
_SO = os.path.join(BUILD_DIR, "libsatd35.so")
_lib = None


def _bind(lib):
    lib.satd35_launch.restype = ctypes.c_int
    lib.satd35_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def load_kernel():
    """Build (at first use, from the source in the package, into the
    git-ignored build directory) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(cuda_build.build(_CSRC, _SO)))
    return _lib


def load_host_build(out):
    """Build the kernel's source for the CPU into the file `out` (what the
    CPU tests run to hold the kernel's body against the plain version) and
    bind it."""
    return _bind(ctypes.CDLL(cuda_build.host_build(_CSRC, out)))


def run(lib, r_u, r_f, orig, n, *, component="luma", bit_depth=8,
        stream=None):
    """Check the operands, allocate the [B, 35] output on their device and
    call `satd35_launch` of `lib` once. Raises on any operand the kernel
    does not take and on a launch error."""
    if n not in (4, 8, 16):
        raise ValueError(f"satd35 kernel takes n in (4, 8, 16), got {n}")
    if bit_depth != 8:
        raise ValueError("satd35 kernel takes 8-bit samples only")
    B = r_u.shape[0]
    R = 4 * n + 1
    for name, t, shape in (("r_u", r_u, (B, R)), ("r_f", r_f, (B, R)),
                           ("orig", orig, (B, n, n))):
        if t.device != r_u.device:
            raise ValueError(f"{name}: expected a tensor on {r_u.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    out = torch.empty((B, 35), dtype=torch.int32, device=r_u.device)
    if B == 0:
        return out
    dc_edge = int(component == "luma" and n < 32)
    err = lib.satd35_launch(r_u.data_ptr(), r_f.data_ptr(), orig.data_ptr(),
                            out.data_ptr(), B, n, dc_edge, stream)
    if err != 0:
        raise RuntimeError(f"satd35 kernel launch failed: CUDA error {err}")
    return out


def _satd_all_modes_cuda(r_u, r_f, orig, n, *, component, bit_depth):
    """Launch the kernel on CUDA tensors (or raise)."""
    global launches
    if not r_u.is_cuda:
        raise ValueError("the satd35 kernel takes CUDA tensors")
    lib = load_kernel()
    with torch.cuda.device(r_u.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = run(lib, r_u, r_f, orig, n, component=component,
                  bit_depth=bit_depth, stream=stream)
    if r_u.shape[0]:
        launches += 1
    return out


def satd_all_modes(r_u, r_f, orig, n, *, component="luma", bit_depth=8):
    """[B, 35] int32 Hadamard SATD of every intra mode vs `orig` [B, n, n].

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version."""
    if r_u.is_cuda:
        return _satd_all_modes_cuda(r_u, r_f, orig, n, component=component,
                                    bit_depth=bit_depth)
    return satd_all_modes_plain(r_u, r_f, orig, n, component=component,
                                bit_depth=bit_depth)
