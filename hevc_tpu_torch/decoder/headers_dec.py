"""SPS/PPS/slice-header/SEI parsing (H.265 7.3.2, D.2.19).

Parses the Main-profile toolset emitted by ..entropy.headers (reference
counterpart: TDecCAVLC.cpp parse{SPS,PPS,SliceHeader}). Fields outside
the toolset raise `nal.StreamError` rather than being silently ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .nal import BitReader, require


def _skip_profile_tier_level(r: BitReader):
    r.u(2 + 1 + 5)          # profile space / tier / profile idc
    r.u(32)                 # compatibility flags
    r.u(4)                  # progressive/interlaced/non-packed/frame-only
    r.u(32)                 # reserved 43 bits
    r.u(11)
    r.u(1)
    r.u(8)                  # level_idc


@dataclass
class Sps:
    pad_width: int = 0
    pad_height: int = 0
    crop_left: int = 0
    crop_right: int = 0      # in chroma units, as written
    crop_top: int = 0
    crop_bottom: int = 0
    bit_depth: int = 8
    log2_max_poc_lsb: int = 8
    log2_min_cu: int = 3
    log2_ctu: int = 6
    log2_min_tu: int = 2
    log2_max_tu: int = 5
    sao: bool = False
    amp: bool = False

    @property
    def width(self):
        return self.pad_width - 2 * (self.crop_left + self.crop_right)

    @property
    def height(self):
        return self.pad_height - 2 * (self.crop_top + self.crop_bottom)

    @property
    def ctus_x(self):
        return -(-self.pad_width // (1 << self.log2_ctu))

    @property
    def ctus_y(self):
        return -(-self.pad_height // (1 << self.log2_ctu))


def parse_sps(rbsp: bytes) -> Sps:
    r = BitReader(rbsp)
    r.u(4)                      # sps_video_parameter_set_id
    max_sub_layers = r.u(3)
    require(max_sub_layers == 0, "multi-sublayer streams unsupported")
    r.u(1)                      # temporal_id_nesting
    _skip_profile_tier_level(r)
    r.ue()                      # sps_seq_parameter_set_id
    chroma = r.ue()
    require(chroma == 1,
            f"only 4:2:0 supported (chroma_format_idc {chroma})")
    sps = Sps()
    sps.pad_width = r.ue()
    sps.pad_height = r.ue()
    if r.u(1):                  # conformance_window_flag
        sps.crop_left = r.ue()
        sps.crop_right = r.ue()
        sps.crop_top = r.ue()
        sps.crop_bottom = r.ue()
    sps.bit_depth = 8 + r.ue()
    bdc = 8 + r.ue()
    require(sps.bit_depth == 8 and bdc == 8, "only 8-bit supported")
    sps.log2_max_poc_lsb = 4 + r.ue()
    r.u(1)                      # sub_layer_ordering_info_present
    r.ue(); r.ue(); r.ue()      # dec_pic_buffering / reorder / latency
    sps.log2_min_cu = 3 + r.ue()
    sps.log2_ctu = sps.log2_min_cu + r.ue()
    sps.log2_min_tu = 2 + r.ue()
    sps.log2_max_tu = sps.log2_min_tu + r.ue()
    r.ue()                      # max_transform_hierarchy_depth_inter
    r.ue()                      # max_transform_hierarchy_depth_intra
    require(r.u(1) == 0, "scaling lists unsupported")
    sps.amp = bool(r.u(1))
    sps.sao = bool(r.u(1))
    require(r.u(1) == 0, "PCM unsupported")
    n_rps = r.ue()
    require(n_rps == 0, "SPS RPS lists unsupported (slice-level RPS only)")
    require(r.u(1) == 0, "long-term ref pics unsupported")
    require(r.u(1) == 0, "temporal MVP unsupported")
    r.u(1)                      # strong_intra_smoothing
    r.u(1)                      # vui_present (toolset: 0)
    r.u(1)                      # sps_extension
    return sps


@dataclass
class Pps:
    init_qp: int = 26
    deblock_disabled: bool = True
    cu_qp_delta: bool = False
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    sign_data_hiding: bool = False
    num_ref_l0_default: int = 1


def parse_pps(rbsp: bytes) -> Pps:
    r = BitReader(rbsp)
    pps = Pps()
    r.ue(); r.ue()              # pps id / sps id
    require(r.u(1) == 0, "dependent slice segments unsupported")
    r.u(1)                      # output_flag_present
    r.u(3)                      # num_extra_slice_header_bits
    pps.sign_data_hiding = bool(r.u(1))
    require(r.u(1) == 0, "cabac_init_present unsupported")
    pps.num_ref_l0_default = r.ue() + 1
    r.ue()                      # num_ref_idx_l1_default
    pps.init_qp = 26 + r.se()
    r.u(1)                      # constrained_intra_pred
    require(r.u(1) == 0, "transform_skip unsupported")
    pps.cu_qp_delta = bool(r.u(1))
    if pps.cu_qp_delta:
        require(r.ue() == 0, "diff_cu_qp_depth != 0 unsupported")
    pps.cb_qp_offset = r.se()
    pps.cr_qp_offset = r.se()
    r.u(1)                      # slice chroma qp offsets present
    require(r.u(1) == 0 and r.u(1) == 0, "weighted pred unsupported")
    require(r.u(1) == 0, "transquant bypass unsupported")
    require(r.u(1) == 0 and r.u(1) == 0, "tiles/WPP unsupported")
    r.u(1)                      # loop_filter_across_slices
    if r.u(1):                  # deblocking_filter_control_present
        require(r.u(1) == 0, "deblocking override unsupported")
        pps.deblock_disabled = bool(r.u(1))
        if not pps.deblock_disabled:
            r.se(); r.se()      # beta/tc offsets (toolset: 0)
    require(r.u(1) == 0, "PPS scaling lists unsupported")
    r.u(1)                      # lists_modification_present
    r.ue()                      # log2_parallel_merge_level_minus2
    r.u(1)                      # slice_segment_header_extension
    return pps


@dataclass
class SliceHeader:
    slice_type: int = 2          # 2 = I, 1 = P
    qp: int = 32
    poc_lsb: int = 0
    sao_luma: bool = False
    sao_chroma: bool = False
    max_merge_cand: int = 5
    ref_deltas: tuple = ()       # POC deltas (>0) of RefPicList0 entries
    n_active_refs: int = 1       # num_ref_idx_l0_active
    data: bytes = b""            # CABAC slice payload (byte-aligned)


def parse_slice_header(rbsp: bytes, sps: Sps, pps: Pps,
                       is_idr: bool) -> SliceHeader:
    r = BitReader(rbsp)
    sh = SliceHeader()
    first = r.u(1)
    require(first == 1, "multi-slice pictures unsupported")
    if is_idr:
        r.u(1)                  # no_output_of_prior_pics
    r.ue()                      # slice_pic_parameter_set_id
    sh.slice_type = r.ue()
    require(sh.slice_type in (0, 1, 2), f"slice type {sh.slice_type}")
    if not is_idr:
        sh.poc_lsb = r.u(sps.log2_max_poc_lsb)
        require(r.u(1) == 0, "RPS taken from the SPS unsupported")
        neg = r.ue()
        pos = r.ue()
        require(pos == 0, "future references unsupported (low delay)")
        deltas, delta = [], 0
        for _ in range(neg):
            delta += r.ue() + 1     # delta_poc_s0_minus1
            used = r.u(1)           # used_by_curr_pic_s0_flag
            if used:
                deltas.append(delta)
        sh.ref_deltas = tuple(deltas)
    sh.n_active_refs = pps.num_ref_l0_default
    if sps.sao:
        sh.sao_luma = bool(r.u(1))
        sh.sao_chroma = bool(r.u(1))
    if sh.slice_type in (0, 1):
        if r.u(1):              # num_ref_idx_active_override_flag
            sh.n_active_refs = r.ue() + 1
            if sh.slice_type == 0:
                r.ue()          # num_ref_idx_l1_active_minus1
        if sh.slice_type == 0:
            r.u(1)              # mvd_l1_zero_flag
        sh.max_merge_cand = 5 - r.ue()
    sh.qp = pps.init_qp + r.se()
    # 7.3.6.1: slice_loop_filter_across_slices_enabled_flag present iff
    # slice_sao_luma || slice_sao_chroma || !deblocking_disabled
    if sh.sao_luma or sh.sao_chroma or not pps.deblock_disabled:
        r.u(1)                  # slice_loop_filter_across_slices
    # byte_alignment() (7.3.2.10): one alignment_bit_equal_to_one, then
    # zero bits to the boundary — the '1' is consumed even when the
    # header already ends byte-aligned (it then occupies a full byte)
    require(r.u(1) == 1, "alignment_bit_equal_to_one missing")
    while r.bit != 0:
        r.u(1)
    sh.data = r.remaining_bytes()
    return sh


def parse_hash_sei(rbsp: bytes) -> Optional[list]:
    """decoded_picture_hash SEI -> [md5_y, md5_cb, md5_cr] or None."""
    r = BitReader(rbsp)
    ptype = 0
    while True:
        b = r.u(8)
        ptype += b
        if b != 255:
            break
    psize = 0
    while True:
        b = r.u(8)
        psize += b
        if b != 255:
            break
    if ptype != 132:            # decoded_picture_hash
        return None
    hash_type = r.u(8)
    per = {0: 16, 1: 2, 2: 4}.get(hash_type)   # MD5 / CRC / checksum
    if per is None:
        return None
    return hash_type, [bytes(r.u(8) for _ in range(per)) for _ in range(3)]
