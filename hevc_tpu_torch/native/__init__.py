"""Native (C++) runtime components, loaded via ctypes.

hevc_entropy: slice-data CABAC encoder, byte-for-byte equal to the
Python entropy layer (parity-tested) but far faster — the host-side
serial stage behind the device compute. The shared library is built
with g++ at first use into the package's git-ignored build directory.
Both entry points are bound: I slices (`encode_slice_data`) and P or
low-delay B slices (`encode_slice_data_p`: multi-reference motion with
POC scaling, SAO, intra-in-P, rectangular PUs and per-CTB QP).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .. import BUILD_DIR

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "hevc_entropy.cpp")
_SO = os.path.join(BUILD_DIR, "hevc_entropy.so")

_lib = None

_I32P = ctypes.POINTER(ctypes.c_int32)


def _build():
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, _SO)      # atomic: parallel processes never load a half-written file


def load():
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        _build()
    lib = ctypes.CDLL(_SO)
    lib.hevc_encode_slice.restype = ctypes.c_int
    lib.hevc_encode_slice.argtypes = [_I32P] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int] + [_I32P] * 6
    lib.hevc_encode_slice_p.restype = ctypes.c_int
    lib.hevc_encode_slice_p.argtypes = [_I32P] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        _I32P, ctypes.c_int, ctypes.c_int, _I32P] + [_I32P] * 8
    _lib = lib
    return lib


def _as_i32(a):
    return np.ascontiguousarray(a, np.int32)


def _ptr(a, t=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(t))


_NULL = _I32P()


def _sao_ptrs(sao):
    """(keepalive, 4 pointers) for an ops/sao.SaoParams (or None)."""
    if sao is None:
        return None, (_NULL, _NULL, _NULL, _NULL)
    t = _as_i32(sao.type_idx)
    e = _as_i32(sao.eo_class)
    b = _as_i32(sao.band_pos)
    o = _as_i32(sao.offsets)
    return (t, e, b, o), (_ptr(t), _ptr(e), _ptr(b), _ptr(o))


def encode_slice_data(depth8, modes8, coef_y, coef_cb, coef_cr,
                      pad_w: int, pad_h: int, qp: int,
                      modes4=None, nxn8=None, sao=None) -> bytes:
    """CABAC-encode the slice data; returns byte-aligned RBSP bytes.
    modes4/nxn8: optional intra-NxN decisions (None = all 2Nx2N).
    sao: optional ops/sao.SaoParams coded per CTU (7.3.8.3)."""
    lib = load()
    d8, m8 = _as_i32(depth8), _as_i32(modes8)
    cy, cb, cr = _as_i32(coef_y), _as_i32(coef_cb), _as_i32(coef_cr)
    cap = max(1 << 16, cy.size * 4)
    out = np.empty(cap, np.uint8)
    m4 = _as_i32(modes4) if modes4 is not None else None
    nx = _as_i32(nxn8) if nxn8 is not None else None
    _keep, sp = _sao_ptrs(sao)
    n = lib.hevc_encode_slice(_ptr(d8), _ptr(m8), _ptr(cy), _ptr(cb),
                              _ptr(cr), pad_w, pad_h, qp,
                              _ptr(out, ctypes.c_uint8), cap,
                              _ptr(m4) if m4 is not None else _NULL,
                              _ptr(nx) if nx is not None else _NULL,
                              *sp)
    if n < 0:
        raise RuntimeError("hevc_encode_slice failed (buffer too small?)")
    return out[:n].tobytes()


def encode_slice_data_p(depth8, mvq8, coef_y, coef_cb, coef_cr,
                        pad_w: int, pad_h: int, qp: int,
                        is_b: bool = False, ref8=None, n_refs: int = 1,
                        poc: int = 1, ref_pocs=None, sao=None,
                        intra8=None, imode8=None, part8=None,
                        qp_map=None) -> bytes:
    """CABAC-encode a P (or low-delay B) slice's data (native).
    ref8: optional [H8, W8] L0 refIdx per 8x8 unit (None = all 0);
    ref_pocs: POC of each active L0 reference (default poc-1-i);
    intra8/imode8: optional intra-in-P decision maps ([H8, W8]: CU
    intra flag + intra luma mode); part8: optional [H8, W8] PU
    partition per cell (0 = 2Nx2N, 1 = 2NxN, 2 = Nx2N);
    qp_map: optional [ny, nx] per-CTB QP (cu_qp_delta syntax, LCU
    rate control). Combined with intra-in-P the delta inside the
    shared I-slice TU machinery is not wired, so that combination
    raises NotImplementedError (there is no other coder to take it)."""
    if qp_map is not None and intra8 is not None:
        raise NotImplementedError(
            "cu_qp_delta + intra-in-P is not wired in the native coder")
    lib = load()
    d8 = _as_i32(depth8)
    mv = _as_i32(mvq8)
    cy, cb, cr = _as_i32(coef_y), _as_i32(coef_cb), _as_i32(coef_cr)
    cap = max(1 << 16, cy.size * 4)
    out = np.empty(cap, np.uint8)
    r8 = _as_i32(ref8) if ref8 is not None else None
    rp = _as_i32(ref_pocs if ref_pocs is not None
                 else [poc - 1 - i for i in range(n_refs)])
    _keep, sp = _sao_ptrs(sao)
    i8 = m4 = None
    if intra8 is not None:
        i8 = _as_i32(intra8)
        # 4x4-granularity mode map, DC (1) at non-intra positions (the
        # MPM neighbour rule for non-intra neighbours)
        m4 = _as_i32(np.repeat(np.repeat(
            np.where(np.asarray(intra8, bool), np.asarray(imode8), 1),
            2, 0), 2, 1))
    p8 = _as_i32(part8) if part8 is not None else None
    qm = _as_i32(qp_map) if qp_map is not None else None
    n = lib.hevc_encode_slice_p(_ptr(d8), _ptr(mv), _ptr(cy), _ptr(cb),
                                _ptr(cr), pad_w, pad_h, qp,
                                _ptr(out, ctypes.c_uint8), cap, int(is_b),
                                _ptr(r8) if r8 is not None else _NULL,
                                int(n_refs), int(poc), _ptr(rp), *sp,
                                _ptr(i8) if i8 is not None else _NULL,
                                _ptr(m4) if m4 is not None else _NULL,
                                _ptr(p8) if p8 is not None else _NULL,
                                _ptr(qm) if qm is not None else _NULL)
    if n < 0:
        raise RuntimeError("hevc_encode_slice_p failed")
    return out[:n].tobytes()
