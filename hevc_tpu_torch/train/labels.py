"""Ground-truth CU-depth label extraction.

Two sources, mirroring the reference's pipeline:

1. `extract_labels_own`: the encoder's own full (ungated) SATD partition
   search (`pipeline/ai.AIEncoder.decide_frame`, the 35-mode SATD kernel
   on the card). Matches the encoder's decision space.
2. `extract_labels_hm`: drive the HM-16.5 Extract_Data encoder binary
   (full RDO; the source of the reference's AI_Info label dumps, HM
   TEncSlice.cpp:813-985) and parse its Info_*_CUDepth.dat output: 1 byte
   per 16x16 unit per frame, frame-major raster.

Label semantics (reference TEncSlice.cpp:880-888): depth 0..3 at 16x16
granularity; the 4x4 map per CTU feeds the pool/ReLU level decomposition.

Also the HM configuration texts the baselines and the BD-rate harness run
HM with (`hm_intra_cfg`, `hm_ldp_cfg`). The Low-Delay-P labels (the
reference's `extract_labels_ldp`, which needs `LDPEncoder.encode(
collect=)`) are not ported yet.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import tempfile

import numpy as np

from ..core.yuv import pad_frame, write_yuv420
from ..evaltools.hm import ENCODER as HM_ENCODER


def extract_labels_own(frames, qp: int, width: int, height: int,
                       device=None):
    """[F, ceil(h/16), ceil(w/16)] uint8 depth labels from the port's
    ungated search. device=None means the card (raises without one)."""
    from ..entropy import headers
    from ..pipeline.ai import AIEncoder

    cfg = headers.EncoderConfig(width=width, height=height, qp=qp)
    enc = AIEncoder(cfg, device=device)
    out = []
    for f in frames:
        pf = pad_frame(f, cfg.pad_width, cfg.pad_height)
        d8, _ = enc.decide_frame(pf.y, qp, pf.cb, pf.cr)
        out.append(d8[::2, ::2].astype(np.uint8))
    return np.stack(out)


def parse_info_index(path):
    """Parse a reference Info_*_Index.dat (text: `POC W H QP [srcpath]`
    per frame, written by the Extract_Data hook,
    reference TAppEncCfg.cpp:2316-2334 + TEncSlice.cpp:905-926).

    Returns (pocs [F], width, height, qps [F], src_path or None).
    AI dumps carry one constant QP; LDP dumps record the per-frame
    slice QP (base + the GOP-4 offsets of encoder_lowdelay_P_main.cfg),
    so the QP column is an array."""
    pocs, widths, heights, qps, src = [], [], [], [], None
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            pocs.append(int(parts[0]))
            widths.append(int(parts[1]))
            heights.append(int(parts[2]))
            qps.append(int(parts[3]))
            if len(parts) > 4 and src is None:
                src = parts[4]
    assert len(set(widths)) == 1 and len(set(heights)) == 1, path
    return (np.asarray(pocs, np.int32), widths[0], heights[0],
            np.asarray(qps, np.int32), src)


def read_shipped_labels(cu_depth_path, index_path=None):
    """Read a reference Info_*_CUDepth.dat label dump.

    Layout (reference TEncSlice.cpp:880-905, consumed by
    Extract_Data/extract_data_AI.py read_info_frame): one uint8 depth
    (0..3) per fully-inside 16x16 unit, raster order, frames
    concatenated; unit counts are floor(dim/16) of the min-CU(8)-padded
    dims. Returns (labels [F, H16, W16] uint8, index tuple or None).

    Works on both the shipped AI_Info/ and LDP_Info/ files and on our
    own HM-driven dumps (extract_labels_hm uses the same layout).
    """
    index = None
    if index_path is None:
        cand = cu_depth_path.replace("_CUDepth.dat", "_Index.dat")
        if os.path.exists(cand):
            index_path = cand
    if index_path is not None:
        index = parse_info_index(index_path)
        width, height = index[1], index[2]
    else:
        m = re.search(r"_(\d+)x(\d+)_", os.path.basename(cu_depth_path))
        if not m:
            raise ValueError(f"no Index file and no WxH in name: "
                             f"{cu_depth_path}")
        width, height = int(m.group(1)), int(m.group(2))
    pw = -(-width // 8) * 8
    ph = -(-height // 8) * 8
    w16, h16 = pw // 16, ph // 16
    data = np.fromfile(cu_depth_path, np.uint8)
    per_frame = w16 * h16
    if data.size % per_frame:
        raise ValueError(
            f"{cu_depth_path}: {data.size} bytes not a multiple of "
            f"{per_frame} ({w16}x{h16} units)")
    labels = data.reshape(-1, h16, w16)
    return labels, index


def hm_intra_cfg(width, height, qp, n_frames):
    """Minimal HM all-intra config (mirrors encoder_intra_main.cfg's
    operating point: CTU 64, depth 4, TU 4..32, IntraPeriod 1)."""
    return f"""
InputBitDepth: 8
FrameRate: 30
FrameSkip: 0
SourceWidth: {width}
SourceHeight: {height}
FramesToBeEncoded: {n_frames}
Profile: main
IntraPeriod: 1
DecodingRefreshType: 1
GOPSize: 1
MaxCUWidth: 64
MaxCUHeight: 64
MaxPartitionDepth: 4
QuadtreeTULog2MaxSize: 5
QuadtreeTULog2MinSize: 2
QuadtreeTUMaxDepthInter: 3
QuadtreeTUMaxDepthIntra: 3
QP: {qp}
TransformSkip: 0
TransformSkipFast: 0
SAO: 1
AMP: 1
RDOQ: 1
RDOQTS: 1
RateControl: 0
LoopFilterOffsetInPPS: 0
LoopFilterDisable: 0
SEIDecodedPictureHash: 1
InternalBitDepth: 8
"""


def hm_ldp_cfg(width, height, qp, n_frames):
    """Minimal HM low-delay-P config mirroring the reference operating
    point (encoder_lowdelay_P_main.cfg: GOPSize 4, QP offsets 3/2/3/1,
    4 active references, TZ search, RDOQ+SAO on)."""
    return f"""
InputBitDepth: 8
FrameRate: 30
FrameSkip: 0
SourceWidth: {width}
SourceHeight: {height}
FramesToBeEncoded: {n_frames}
Profile: main
IntraPeriod: -1
DecodingRefreshType: 0
GOPSize: 4
Frame1:  P 1 3 0.4624 0 0 0 4 4 -1 -5 -9 -13 0
Frame2:  P 2 2 0.4624 0 0 0 4 4 -1 -2 -6 -10 1 -1 5 1 1 1 0 1
Frame3:  P 3 3 0.4624 0 0 0 4 4 -1 -3 -7 -11 1 -1 5 0 1 1 1 1
Frame4:  P 4 1 0.578  0 0 0 4 4 -1 -4 -8 -12 1 -1 5 0 1 1 1 1
MaxCUWidth: 64
MaxCUHeight: 64
MaxPartitionDepth: 4
QuadtreeTULog2MaxSize: 5
QuadtreeTULog2MinSize: 2
QuadtreeTUMaxDepthInter: 3
QuadtreeTUMaxDepthIntra: 3
FastSearch: 1
SearchRange: 64
HadamardME: 1
FEN: 1
FDM: 1
QP: {qp}
TransformSkip: 0
TransformSkipFast: 0
SAO: 1
AMP: 1
RDOQ: 1
RDOQTS: 1
RateControl: 0
LoopFilterOffsetInPPS: 1
LoopFilterDisable: 0
SEIDecodedPictureHash: 1
InternalBitDepth: 8
"""


def extract_labels_hm(frames, qp: int, width: int, height: int,
                      workdir: str = None, timeout: int = 1800):
    """Run the HM Extract_Data encoder; parse its CU-depth dumps.

    Returns [F, floor(pw/16)... ] uint8: HM dumps the fully-inside 16x16
    units of the source padded to the minimum CU (8). workdir=None works
    in a temporary directory that is removed afterwards.
    """
    if not os.path.exists(HM_ENCODER):
        raise FileNotFoundError(f"HM encoder missing: {HM_ENCODER}")
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="hm_extract_") as td:
            return extract_labels_hm(frames, qp, width, height, td, timeout)
    write_yuv420(os.path.join(workdir, "in.yuv"), frames)
    with open(os.path.join(workdir, "enc.cfg"), "w") as f:
        f.write(hm_intra_cfg(width, height, qp, len(frames)))
    proc = subprocess.run(
        [HM_ENCODER, "-c", "enc.cfg", "-i", "in.yuv", "-b", "str.bin",
         "-o", "rec.yuv"],
        cwd=workdir, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"HM encoder failed:\n{proc.stdout}\n{proc.stderr}")
    depth_files = sorted(glob.glob(os.path.join(workdir, "*_CUDepth.dat")))
    if not depth_files:
        raise RuntimeError(f"no CUDepth dump found in {workdir}")
    data = np.fromfile(depth_files[-1], np.uint8)
    # HM dumps floor(internalDim/16) units (only fully-inside 16x16 units;
    # internal dims are the source padded to min-CU=8 multiples) — see
    # reference TEncSlice.cpp:880-905 (fwrite of (iWidth/16)*(iHeight/16)).
    pw = -(-width // 8) * 8
    ph = -(-height // 8) * 8
    w16, h16 = pw // 16, ph // 16
    per_frame = w16 * h16
    n = data.size // per_frame
    return data[:n * per_frame].reshape(n, h16, w16)
