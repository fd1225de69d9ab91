"""Normative re-coding of intra CUs inside P frames (intra-in-P).

The batched P search (pipeline/psearch) decides which CUs are intra
using original-pixel references (the All-Intra search's approximation);
this module then codes those CUs normatively — prediction from
reconstructed neighbours, exact integer transform and quantization — by
patching the inter-reconstructed planes in coding (z-) order. Inter CUs
never reference the current frame, so only intra CUs need this
sequential pass; with few intra CUs per frame (occlusions, scene
changes) the host NumPy walk is cheap.

Behavioral counterpart: HM xCheckRDCostIntra inside P slices
(TEncCu.cpp:1438; LDP hook HM-16.5_Test_LDP/TEncCu.cpp:746-803).
TU coder: pipeline/golden._code_tu.
"""

from __future__ import annotations

from ..core import zorder
from ..ops import quant
from . import golden


def patch_intra_cus(orig_y, orig_cb, orig_cr, rec_y, rec_cb, rec_cr,
                    coef_y, coef_cb, coef_cr, depth8, intra8, imode8,
                    qp: int, pad_w: int, pad_h: int, rdoq: bool = True):
    """Re-code every intra CU in place (the planes are int32 NumPy
    arrays, modified destructively). Returns nothing."""
    zmap = zorder.frame_zmap(pad_w, pad_h)
    cqp = quant.chroma_qp(qp)
    nx, ny = pad_w // 64, pad_h // 64
    lkw = dict(component="luma", pad_w=pad_w, pad_h=pad_h, rdoq=rdoq)
    ckw = dict(component="chroma", pad_w=pad_w // 2, pad_h=pad_h // 2,
               scale=2, rdoq=rdoq)

    def code_cu(x0, y0, size):
        mode = int(imode8[y0 >> 3, x0 >> 3])
        if size == 64:
            for dx, dy in ((0, 0), (32, 0), (0, 32), (32, 32)):
                golden._code_tu(orig_y, rec_y, coef_y, zmap, x0 + dx,
                                y0 + dy, 32, mode, qp, **lkw)
            for dx, dy in ((0, 0), (16, 0), (0, 16), (16, 16)):
                cx, cy = (x0 >> 1) + dx, (y0 >> 1) + dy
                golden._code_tu(orig_cb, rec_cb, coef_cb, zmap, cx, cy,
                                16, mode, cqp, **ckw)
                golden._code_tu(orig_cr, rec_cr, coef_cr, zmap, cx, cy,
                                16, mode, cqp, **ckw)
        else:
            golden._code_tu(orig_y, rec_y, coef_y, zmap, x0, y0, size,
                            mode, qp, **lkw)
            half = size >> 1
            golden._code_tu(orig_cb, rec_cb, coef_cb, zmap, x0 >> 1,
                            y0 >> 1, half, mode, cqp, **ckw)
            golden._code_tu(orig_cr, rec_cr, coef_cr, zmap, x0 >> 1,
                            y0 >> 1, half, mode, cqp, **ckw)

    def walk(x0, y0, size, depth):
        if x0 >= pad_w or y0 >= pad_h:
            return
        if int(depth8[y0 >> 3, x0 >> 3]) > depth:
            h = size >> 1
            for dx, dy in ((0, 0), (h, 0), (0, h), (h, h)):
                walk(x0 + dx, y0 + dy, h, depth + 1)
            return
        if intra8[y0 >> 3, x0 >> 3]:
            code_cu(x0, y0, size)

    for ci in range(nx * ny):
        cy, cx = divmod(ci, nx)
        walk(cx * 64, cy * 64, 64, 0)
