"""Decoder top level: Annex-B stream -> decoded pictures + hash check.

Counterpart of the reference TAppDecoder/TDecTop flow (TDecTop.cpp:725):
NAL dispatch, parameter-set activation, slice decode, reconstruction,
in-loop filters, decoded-picture-hash SEI verification, conformance-
window cropping. The reference pictures stay on the decoder's device;
each picture goes to the host once, for its hash and the output.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from .. import resolve_device
from ..core.yuv import Frame
from ..pipeline.golden import _HASH_FN
from . import nal as nal_mod
from .nal import require
from . import headers_dec as hd
from . import recon_dec, slice_dec

NAL_TRAIL_R = 1
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


@dataclass
class DecodeResult:
    frames: List[Frame] = field(default_factory=list)   # cropped output
    recons: List[Frame] = field(default_factory=list)   # padded (pre-crop)
    hash_ok: List[Optional[bool]] = field(default_factory=list)
    sps: Optional[hd.Sps] = None
    pps: Optional[hd.Pps] = None

    @property
    def all_hashes_ok(self) -> bool:
        return all(h is not False for h in self.hash_ok)


def _crop(frame: Frame, sps: hd.Sps) -> Frame:
    W, H = sps.width, sps.height
    return Frame(frame.y[:H, :W], frame.cb[:H // 2, :W // 2],
                 frame.cr[:H // 2, :W // 2])


def decode_annexb(stream: bytes, device=None) -> DecodeResult:
    """Decode a full Annex-B stream of the framework's toolset.
    device=None means the card; with no card that raises (pass
    device="cpu" to decode on the CPU)."""
    device = resolve_device(device)
    res = DecodeResult()
    sps: Optional[hd.Sps] = None
    pps: Optional[hd.Pps] = None
    dpb = {}                      # poc -> padded (y, cb, cr) device planes
    poc = 0

    for nu in nal_mod.split_annexb(stream):
        t = nu.nal_type
        if t == NAL_VPS:
            continue
        if t == NAL_SPS:
            sps = hd.parse_sps(nu.rbsp)
            res.sps = sps
            continue
        if t == NAL_PPS:
            pps = hd.parse_pps(nu.rbsp)
            res.pps = pps
            continue
        if t in (NAL_PREFIX_SEI, NAL_SUFFIX_SEI):
            parsed = hd.parse_hash_sei(nu.rbsp)
            if parsed is not None and res.recons:
                htype, hashes = parsed
                fn = _HASH_FN[htype]
                rec = res.recons[-1]
                ok = (fn(rec.y) == hashes[0] and fn(rec.cb) == hashes[1]
                      and fn(rec.cr) == hashes[2])
                res.hash_ok[-1] = bool(ok)
            continue
        if t in (NAL_IDR_W_RADL, NAL_IDR_N_LP, NAL_TRAIL_R):
            require(sps is not None and pps is not None,
                    "slice before parameter sets")
            is_idr = t in (NAL_IDR_W_RADL, NAL_IDR_N_LP)
            sh = hd.parse_slice_header(nu.rbsp, sps, pps, is_idr)
            if is_idr:
                poc = 0
                dpb.clear()
            else:
                # low-delay streams: decode order == POC order; the
                # poc_lsb check guards the assumption
                poc += 1
                mask = (1 << sps.log2_max_poc_lsb) - 1
                require(sh.poc_lsb == (poc & mask), "POC discontinuity")
            W, H = sps.pad_width, sps.pad_height
            if pps.cu_qp_delta and not pps.deblock_disabled:
                raise NotImplementedError(
                    "cu_qp_delta with deblocking: the per-CU QP of the "
                    "deblocking filter (8.7.2.5.3) is not ported")
            sao_on = sps.sao and (sh.sao_luma or sh.sao_chroma)
            if sh.slice_type == 2:
                dec = slice_dec.ISliceDecoder(
                    sps, sh.qp, sao_on,
                    cu_qp_delta=pps.cu_qp_delta).decode(sh.data)
                rec = recon_dec.recon_intra_frame(dec, W, H, sh.qp)
                rec = (rec.y, rec.cb, rec.cr)
                inter_pic = False
            else:
                # RefPicList0 from the slice RPS deltas, clipped to the
                # active count (8.3.4)
                deltas = list(sh.ref_deltas)[:sh.n_active_refs]
                while len(deltas) < sh.n_active_refs:
                    deltas.append(deltas[-1] if deltas else 1)
                refs = [dpb[poc - d] for d in deltas]
                ref_pocs = [poc - d for d in deltas]
                dec = slice_dec.PSliceDecoder(
                    sps, sh.qp, sao_on, is_b=sh.slice_type == 0,
                    n_refs=sh.n_active_refs, poc=poc,
                    ref_pocs=ref_pocs,
                    cu_qp_delta=pps.cu_qp_delta).decode(sh.data)
                rec = recon_dec.recon_inter_frame(dec, refs, W, H, sh.qp,
                                                  device)
                inter_pic = True
            planes = recon_dec.apply_loop_filters(
                rec, dec, sh.qp, deblock_on=not pps.deblock_disabled,
                sao_on=sao_on, inter_pic=inter_pic, device=device)
            rec = Frame(*(p.to(torch.uint8).cpu().numpy() for p in planes))
            res.recons.append(rec)
            res.frames.append(_crop(rec, sps))
            res.hash_ok.append(None)
            dpb[poc] = planes
            # bound the DPB (keep the last 8 pictures)
            for old_poc in [p for p in dpb if p < poc - 8]:
                del dpb[old_poc]
            continue
        raise nal_mod.StreamError(f"unsupported NAL type {t}")
    return res


def decode_file(path: str, device=None) -> DecodeResult:
    with open(path, "rb") as f:
        return decode_annexb(f.read(), device=device)
