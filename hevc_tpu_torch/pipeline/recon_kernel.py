"""Whole-frame reconstruction kernel: host tables, build, launch.

`csrc/recon_frame.cu` computes, for a batch of F frames and the encoder's
decisions (depth8 / modes4 / nxn8), the normative intra reconstruction and
the quantized coefficients of every transform unit in coding order. The
intra dependency is carried by the launches: one launch per wavefront
diagonal d = ctu_x + 2 * ctu_y covers the three planes Y, Cb and Cr, one
thread block per (CTU of the diagonal, frame, plane). A block picks the
rows of the static step table below that are leaves of its CTU's
quadtree, keeps them in coding order, and codes each leaf TU from
references to write-back in shared memory, in a body compiled once per TU
size (see the note at the top of the source).

This module holds what the kernel needs from the host: the step tables,
the transform matrices, the float32 RDOQ constants, the `nvcc` build, the
operand checks and the launch counter. `pipeline/recon.py` holds the plain
PyTorch version and the entry point that chooses between the two by the
device of the tensors it is given.

Limits: RDOQ model "lite", 8-bit samples, 4:2:0.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from .. import BUILD_DIR, cuda_build
from ..ops import quant, rdoq as rdoq_lib, transforms

#: kernel launches by `encode_frame_planes_cuda` (plain integer; a run that
#: wants to show the kernel was used zeroes it and reads it back). One
#: frame batch adds ctus_x + 2 * (ctus_y - 1): a launch per wavefront
#: diagonal, whichever planes it covers.
launches = 0

#: rows of the luma and chroma step tables: the kernel sizes its leaf list
#: to them (`Shared<S>::ROWS` in the source)
STEP_ROWS = {"luma": 344, "chroma": 88}

#: the planes (blockIdx.z offset and count) of each component selection
_PLANES = {("luma",): (0, 1), ("chroma",): (1, 2), ("chroma", "luma"): (0, 3)}

_CSRC = os.path.join(cuda_build.CSRC_DIR, "recon_frame.cu")
_SO = os.path.join(BUILD_DIR, "librecon_frame.so")
#: the RDOQ costs feed `<=` comparisons: no fused multiply-add
_NVCC_FLAGS = ("-fmad=false",)
_lib = None


# ---------------------------------------------------------------------------
# Host tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def node_table():
    """(depth_class, x0, y0) of the 85 quadtree nodes, DFS pre-order."""
    nodes = []

    def rec(d, x, y):
        nodes.append((d, x, y))
        if d < 3:
            h = 64 >> (d + 1)
            for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):
                rec(d + 1, x + dx, y + dy)

    rec(0, 0, 0)
    return np.array(nodes, np.int32)


@functools.lru_cache(maxsize=None)
def luma_steps():
    """Luma TU steps of one CTU in coding order, [344, 8] int32.

    Columns: cls, tux, tuy, n8x, n8y, dep, m4x, m4y. cls: 0 = 32x32,
    1 = 16x16, 2 = 8x8 (2Nx2N), 3 = 4x4 (NxN, DST). A row is coded when
    the CTU's depth at 8x8 unit (n8x, n8y) equals dep (and, for cls 2 / 3,
    the NxN flag there is clear / set); its mode is modes4 at (m4x, m4y).
    """
    rows = []
    for (d, x0, y0) in node_table():
        d, x0, y0 = int(d), int(x0), int(y0)
        n8x, n8y, m4x, m4y = x0 >> 3, y0 >> 3, x0 >> 2, y0 >> 2
        if d == 0:
            for (dx, dy) in ((0, 0), (32, 0), (0, 32), (32, 32)):
                rows.append((0, x0 + dx, y0 + dy, n8x, n8y, 0, m4x, m4y))
        elif d == 1:
            rows.append((0, x0, y0, n8x, n8y, 1, m4x, m4y))
        elif d == 2:
            rows.append((1, x0, y0, n8x, n8y, 2, m4x, m4y))
        else:
            rows.append((2, x0, y0, n8x, n8y, 3, m4x, m4y))
            for (dx, dy) in ((0, 0), (4, 0), (0, 4), (4, 4)):
                rows.append((3, x0 + dx, y0 + dy, n8x, n8y, 3,
                             (x0 + dx) >> 2, (y0 + dy) >> 2))
    return np.asarray(rows, np.int32)


@functools.lru_cache(maxsize=None)
def chroma_steps():
    """Chroma TU steps of one CTU, [88, 8] int32 (each coded once for Cb
    and once for Cr): as `luma_steps`, with tux/tuy in chroma samples and
    cls 0 = 16x16, 1 = 8x8, 2 = 4x4. The mode is the luma mode of the CU's
    first PU."""
    rows = []
    for (d, x0, y0) in node_table():
        d, x0, y0 = int(d), int(x0), int(y0)
        n8x, n8y, m4x, m4y = x0 >> 3, y0 >> 3, x0 >> 2, y0 >> 2
        cx, cy = x0 >> 1, y0 >> 1
        if d == 0:
            for (dx, dy) in ((0, 0), (16, 0), (0, 16), (16, 16)):
                rows.append((0, cx + dx, cy + dy, n8x, n8y, 0, m4x, m4y))
        else:
            rows.append((d - 1, cx, cy, n8x, n8y, d, m4x, m4y))
    return np.asarray(rows, np.int32)


def rdoq_constants(qp: int):
    """(lambda, (alpha(4), alpha(8), alpha(16), alpha(32))) of the RDOQ
    cost model, each rounded once to float32 as `ops/rdoq.rd_quantize`
    rounds them."""
    lam = float(np.float32(0.57 * 2.0 ** ((qp - 12) / 3.0)))
    return lam, tuple(float(np.float32(rdoq_lib.alpha(n)))
                      for n in (4, 8, 16, 32))


@functools.lru_cache(maxsize=None)
def _tables_t(device):
    """(luma steps, chroma steps, 32-point DCT matrix, DST matrix) as
    contiguous int32 tensors on `device`. The n-point DCT matrix is every
    (32 / n)-th row of the 32-point one, first n columns."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                  device=device)
    return (t(luma_steps()), t(chroma_steps()), t(transforms.dct_matrix(32)),
            t(transforms.dst_matrix()))


# ---------------------------------------------------------------------------
# Build and launch
# ---------------------------------------------------------------------------

def build_job():
    """(source, library, extra flags) for `cuda_build.build_all`."""
    return _CSRC, _SO, _NVCC_FLAGS


def _bind(lib):
    lib.recon_frame_launch.restype = ctypes.c_int
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.recon_frame_launch.argtypes = (
        [c_ptr] * 12 + [c_ptr, c_int] * 2 + [c_ptr] * 2 + [c_int] * 6
        + ([c_int] + [c_float] * 5) * 2 + [c_ptr])
    return lib


def load_kernel():
    """Build (at first use, from the source in the package, into the
    git-ignored build directory) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(cuda_build.build(_CSRC, _SO, _NVCC_FLAGS)))
    return _lib


def load_host_build(out):
    """Build the kernel's source for the CPU into the file `out` (what the
    CPU tests run to hold the kernel's body against the plain version) and
    bind it. The RDOQ costs feed `<=` comparisons: no contraction to fused
    multiply-adds, as on the card."""
    return _bind(ctypes.CDLL(cuda_build.host_build(
        _CSRC, out, ("-ffp-contract=off",))))


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def run(lib, ys, cbs, crs, depth8, modes4, nxn8, *, qp: int, pad_w: int,
        pad_h: int, rdoq: bool, stream,
        components=("luma", "chroma")):
    """Check the operands, allocate the six output planes on their device
    and call `recon_frame_launch` of `lib` once for the planes of
    `components` (luma: Y; chroma: Cb and Cr; both: all three in each
    launch). Returns ((recon_y, recon_cb, recon_cr, coef_y, coef_cb,
    coef_cr), kernel launches made). Raises on any operand the kernel does
    not take and on a launch error."""
    if pad_w % 8 or pad_h % 8 or pad_w <= 0 or pad_h <= 0:
        raise ValueError(f"coded size {pad_w}x{pad_h} is not a positive "
                         "multiple of 8")
    if not 0 <= qp <= 51:
        raise ValueError(f"qp {qp} outside 0..51")
    planes = _PLANES.get(tuple(sorted(set(components))))
    if planes is None:
        raise ValueError(f"components {components!r}: expected luma, "
                         "chroma or both")
    if ys.dim() != 3:
        raise ValueError("ys: expected [F, pad_h, pad_w]")
    F = ys.shape[0]
    dev = ys.device
    hc, wc, h8, w8 = pad_h // 2, pad_w // 2, pad_h // 8, pad_w // 8
    _check("ys", ys, torch.uint8, (F, pad_h, pad_w), dev)
    _check("cbs", cbs, torch.uint8, (F, hc, wc), dev)
    _check("crs", crs, torch.uint8, (F, hc, wc), dev)
    _check("depth8", depth8, torch.int32, (F, h8, w8), dev)
    _check("modes4", modes4, torch.int32, (F, 2 * h8, 2 * w8), dev)
    _check("nxn8", nxn8, torch.bool, (F, h8, w8), dev)
    steps_y, steps_c, t32, dst4 = _tables_t(dev)
    for comp, steps in (("luma", steps_y), ("chroma", steps_c)):
        if steps.shape[0] != STEP_ROWS[comp]:
            raise ValueError(f"{comp} step table has {steps.shape[0]} rows, "
                             f"the kernel takes {STEP_ROWS[comp]}")
    rec = [torch.zeros_like(p) for p in (ys, cbs, crs)]
    coef = [torch.zeros(p.shape, dtype=torch.int16, device=dev)
            for p in (ys, cbs, crs)]
    if F == 0:
        return tuple(rec + coef), 0
    cqp = quant.chroma_qp(qp)
    lam_y, alphas_y = rdoq_constants(qp)
    lam_c, alphas_c = rdoq_constants(cqp)
    made = lib.recon_frame_launch(
        *(t.data_ptr() for t in (ys, cbs, crs, *rec, *coef, depth8, modes4,
                                 nxn8)),
        steps_y.data_ptr(), steps_y.shape[0], steps_c.data_ptr(),
        steps_c.shape[0], t32.data_ptr(), dst4.data_ptr(), F, w8, h8,
        int(bool(rdoq)), *planes, qp, lam_y, *alphas_y, cqp, lam_c,
        *alphas_c, stream)
    if made < 0:
        raise RuntimeError(
            f"recon_frame kernel launch failed: CUDA error {-made}")
    return tuple(rec + coef), made


def encode_frame_planes_cuda(ys, cbs, crs, depth8, modes4, nxn8, *, qp: int,
                             pad_w: int, pad_h: int, rdoq: bool = True,
                             components=("luma", "chroma")):
    """Launch the kernel on CUDA tensors (or raise). ys [F, pad_h, pad_w],
    cbs / crs [F, pad_h/2, pad_w/2] uint8; depth8 [F, pad_h/8, pad_w/8]
    and modes4 [F, pad_h/4, pad_w/4] int32; nxn8 [F, pad_h/8, pad_w/8]
    bool; all contiguous on one CUDA device. The decisions must be legal
    (CUs inside the coded frame, modes 0..34): the kernel does not check
    them. Returns the six planes (recon uint8 Y/Cb/Cr, levels int16
    Y/Cb/Cr) with the leading F; asynchronous on the current stream.
    One launch per wavefront diagonal covers the planes of `components`
    ("luma": Y; "chroma": Cb and Cr; both by default; the planes left out
    come back zero): the measurements time luma and chroma apart."""
    global launches
    if not ys.is_cuda:
        raise ValueError("encode_frame_planes_cuda takes CUDA tensors")
    lib = load_kernel()
    with torch.cuda.device(ys.device):
        stream = torch.cuda.current_stream().cuda_stream
        planes, made = run(lib, ys, cbs, crs, depth8, modes4, nxn8, qp=qp,
                           pad_w=pad_w, pad_h=pad_h, rdoq=rdoq, stream=stream,
                           components=components)
    launches += made
    return planes
