"""HM-compatible configuration parsing (TAppEncCfg parity).

Reads the reference's stacked cfg files (`TAppEncoderStatic -c
encoder_yuv_source.cfg -c encoder_intra_main.cfg`, format of
TAppCommon/program_options_lite.cpp: `Key : value  # comment` lines,
later files override earlier ones) and maps the options our toolset
implements onto EncoderConfig + run settings. The GOP table rows
(Frame1..FrameN) are parsed for per-frame QP offsets.

Unsupported options are accepted and recorded (HM tolerates unknown
keys only with warnings; we keep them in `unknown` for inspection) —
the shipped reference operating points (encoder_intra_main.cfg,
encoder_lowdelay_P_main.cfg, encoder_lowdelay_main.cfg) drive
everything we need.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..entropy.headers import EncoderConfig

_LINE = re.compile(r"^\s*([A-Za-z0-9_]+)\s*:\s*(.*?)\s*(?:#.*)?$")


def parse_hm_cfg_text(text: str, into: Optional[Dict[str, str]] = None):
    """Parse one cfg file's text into {key: raw value string}."""
    opts = into if into is not None else {}
    for line in text.splitlines():
        m = _LINE.match(line)
        if m and m.group(2):
            opts[m.group(1)] = m.group(2)
    return opts


def parse_hm_cfgs(paths: List[str]) -> Dict[str, str]:
    """Stacked cfg files; later files override earlier (HM -c -c)."""
    opts: Dict[str, str] = {}
    for p in paths:
        with open(p) as f:
            parse_hm_cfg_text(f.read(), opts)
    return opts


@dataclass
class RunSettings:
    """Non-bitstream run options (the TAppEncTop frame-pump side)."""
    input_file: str = ""
    bitstream_file: str = "str.bin"
    recon_file: str = ""
    frames_to_encode: int = 1
    frame_skip: int = 0
    frame_rate: float = 30.0
    intra_period: int = 1
    gop_size: int = 1
    mode: str = "ai"            # "ai" (IntraPeriod 1), "ldp", or "ldb"
                                # (GOP rows typed B -> low-delay B slices)
    rc_target_bps: float = 0.0  # RateControl: 1 + TargetBitrate
    unknown: Dict[str, str] = field(default_factory=dict)


_KNOWN = {
    "InputFile", "BitstreamFile", "ReconFile", "SourceWidth",
    "SourceHeight", "FramesToBeEncoded", "FrameSkip", "FrameRate",
    "InputBitDepth", "InputChromaFormat", "QP", "IntraPeriod", "GOPSize",
    "MaxCUWidth", "MaxCUHeight", "MaxPartitionDepth",
    "QuadtreeTULog2MaxSize", "QuadtreeTULog2MinSize", "LoopFilterDisable",
    "SAO", "RDOQ", "Level", "Profile", "DecodingRefreshType",
    "ConformanceWindowMode", "InternalBitDepth", "RateControl",
    "TargetBitrate",
}


def _level_idc(level_str: str) -> int:
    try:
        return int(round(float(level_str) * 30))
    except ValueError:
        return 120


def load_encoder_config(paths: List[str],
                        overrides: Optional[Dict[str, str]] = None
                        ) -> Tuple[EncoderConfig, RunSettings]:
    """HM cfg stack -> (EncoderConfig, RunSettings)."""
    opts = parse_hm_cfgs(paths)
    if overrides:
        opts.update(overrides)

    def geti(key, default):
        return int(opts.get(key, default))

    width = geti("SourceWidth", 0)
    height = geti("SourceHeight", 0)
    if not width or not height:
        raise ValueError("SourceWidth/SourceHeight required")
    if opts.get("MaxCUWidth", "64") != "64" or \
            opts.get("MaxPartitionDepth", "4") != "4":
        raise ValueError("toolset is fixed to CTU 64 / depth 4 "
                         "(reference operating point)")

    intra_period = geti("IntraPeriod", 1)
    gop_size = geti("GOPSize", 1)

    # GOP table: FrameN rows "Type POC QPoffset QPfactor tcOff betaOff
    # tid #ref_pics_active #ref_pics refPics..."
    qp_offsets = []
    gop_types = []
    ref_actives = []
    for i in range(1, gop_size + 1):
        row = opts.get(f"Frame{i}")
        if row:
            parts = row.split()
            if len(parts) >= 3:
                gop_types.append(parts[0].upper())
                qp_offsets.append(int(parts[2]))
            if len(parts) >= 8:
                try:
                    ref_actives.append(int(parts[7]))
                except ValueError:
                    pass
    if intra_period == 1:
        mode = "ai"
    elif gop_types and all(t == "B" for t in gop_types):
        mode = "ldb"          # low-delay B (encoder_lowdelay_main.cfg)
    else:
        mode = "ldp"
    if mode in ("ldp", "ldb") and len(qp_offsets) != gop_size:
        qp_offsets = [3, 2, 3, 1][:max(gop_size, 1)]

    # active reference pictures: the GOP table's #ref_pics_active column
    # (reference LDP/LDB cfgs ship 4); our RPS uses the nearest n
    # previous pictures rather than HM's staggered  -1 -5 -9 -13 layout
    num_refs = (max(ref_actives) if ref_actives else
                (4 if intra_period != 1 else 1))
    cfg = EncoderConfig(
        width=width, height=height, qp=geti("QP", 32),
        deblock=geti("LoopFilterDisable", 0) == 0,
        sao=geti("SAO", 0) != 0,
        rdoq=geti("RDOQ", 1) != 0,
        level_idc=_level_idc(opts.get("Level", "4")),
        gop_qp_offsets=tuple(qp_offsets) if qp_offsets else (3, 2, 3, 1),
        num_refs=(num_refs if intra_period != 1 else 1),
    )
    run = RunSettings(
        input_file=opts.get("InputFile", ""),
        bitstream_file=opts.get("BitstreamFile", "str.bin"),
        recon_file=opts.get("ReconFile", ""),
        frames_to_encode=geti("FramesToBeEncoded", 1),
        frame_skip=geti("FrameSkip", 0),
        frame_rate=float(opts.get("FrameRate", 30)),
        intra_period=intra_period,
        gop_size=gop_size,
        mode=mode,
        rc_target_bps=(float(opts.get("TargetBitrate", 0))
                       if geti("RateControl", 0) else 0.0),
        unknown={k: v for k, v in opts.items()
                 if k not in _KNOWN and not k.startswith("Frame")},
    )
    return cfg, run
