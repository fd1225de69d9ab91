"""VPS/SPS/PPS/slice-header/SEI writing (H.265 7.3.2, D.2).

Fixed Main-profile toolset for the AI path (mirrors the operating point of
the reference encoder_intra_main.cfg: CTU 64, depth 4, TU 4..32, SAO off in
our SPS, deblocking disabled in our PPS, scaling lists off, no WPP/tiles).
"""

from __future__ import annotations

from dataclasses import dataclass

from .bitstream import (BitWriter, nal_unit, NAL_VPS, NAL_SPS, NAL_PPS,
                        NAL_IDR_W_RADL, NAL_SUFFIX_SEI)


@dataclass
class EncoderConfig:
    width: int
    height: int
    qp: int = 32
    bit_depth: int = 8
    level_idc: int = 120          # level 4.0
    deblock: bool = False         # in-loop deblocking (ops/deblock.py)
    sao: bool = False             # sample adaptive offset (ops/sao.py)
    rdoq: bool = True             # RD-optimized quantization (ops/rdoq.py)
    nxn: bool = True              # intra NxN (4x4 PUs/TUs) at 8x8 CUs
    # LDP GOP-4 per-frame QP offsets by POC % 4 (1,2,3,0), matching the
    # reference encoder_lowdelay_P_main.cfg Frame1..4 QPoffset column.
    gop_qp_offsets: tuple = (3, 2, 3, 1)
    # per-CTB QP signalling (LCU-level rate control): PPS
    # cu_qp_delta_enabled_flag with diff_cu_qp_depth = 0 (quantization
    # group = CTB). Reference: TEncRateCtrl.cpp:1402 LCU path.
    cu_qp_delta: bool = False
    # coding-grid alignment: pad to multiples of max(min_cu, pad_align).
    # The LDP/LDB pipeline sets pad_align=64 (whole CTUs only); the SPS
    # conformance window crops the padding back out (7.4.3.2.1).
    pad_align: int = 0
    # decoded-picture-hash SEI variant: 'md5' | 'crc' | 'checksum'
    hash_type: str = "md5"
    # active L0 reference pictures for P/B slices (the n previous
    # pictures; reference LDP cfg ships 4, encoder_lowdelay_P_main.cfg)
    num_refs: int = 1
    # fixed toolset
    ctu_size: int = 64
    min_cu: int = 8
    min_tu: int = 4
    max_tu: int = 32

    @property
    def pad_width(self):
        a = max(self.min_cu, self.pad_align)
        return -(-self.width // a) * a

    @property
    def pad_height(self):
        a = max(self.min_cu, self.pad_align)
        return -(-self.height // a) * a

    @property
    def ctus_x(self):
        return -(-self.pad_width // self.ctu_size)

    @property
    def ctus_y(self):
        return -(-self.pad_height // self.ctu_size)


def _profile_tier_level(bw: BitWriter, level_idc: int):
    bw.u(0, 2)        # general_profile_space
    bw.u(0, 1)        # general_tier_flag
    bw.u(1, 5)        # general_profile_idc = Main
    for i in range(32):
        bw.u(1 if i in (1, 2) else 0, 1)  # compat: Main, Main10
    bw.u(1, 1)        # general_progressive_source_flag
    bw.u(0, 1)        # general_interlaced_source_flag
    bw.u(0, 1)        # general_non_packed_constraint_flag
    bw.u(1, 1)        # general_frame_only_constraint_flag
    bw.u(0, 32)       # reserved 43 bits ...
    bw.u(0, 11)
    bw.u(0, 1)        # general_inbld / reserved
    bw.u(level_idc, 8)


def write_vps(cfg: EncoderConfig) -> bytes:
    bw = BitWriter()
    bw.u(0, 4)        # vps_video_parameter_set_id
    bw.u(1, 1)        # vps_base_layer_internal_flag
    bw.u(1, 1)        # vps_base_layer_available_flag
    bw.u(0, 6)        # vps_max_layers_minus1
    bw.u(0, 3)        # vps_max_sub_layers_minus1
    bw.u(1, 1)        # vps_temporal_id_nesting_flag
    bw.u(0xFFFF, 16)  # vps_reserved_0xffff_16bits
    _profile_tier_level(bw, cfg.level_idc)
    bw.u(1, 1)        # vps_sub_layer_ordering_info_present_flag
    bw.ue(4)          # vps_max_dec_pic_buffering_minus1
    bw.ue(0)          # vps_max_num_reorder_pics
    bw.ue(0)          # vps_max_latency_increase_plus1
    bw.u(0, 6)        # vps_max_layer_id
    bw.ue(0)          # vps_num_layer_sets_minus1
    bw.u(0, 1)        # vps_timing_info_present_flag
    bw.u(0, 1)        # vps_extension_flag
    bw.align_one_then_zero()
    return nal_unit(NAL_VPS, bw.get_bytes())


def write_sps(cfg: EncoderConfig) -> bytes:
    import math
    bw = BitWriter()
    bw.u(0, 4)        # sps_video_parameter_set_id
    bw.u(0, 3)        # sps_max_sub_layers_minus1
    bw.u(1, 1)        # sps_temporal_id_nesting_flag
    _profile_tier_level(bw, cfg.level_idc)
    bw.ue(0)          # sps_seq_parameter_set_id
    bw.ue(1)          # chroma_format_idc = 4:2:0
    bw.ue(cfg.pad_width)
    bw.ue(cfg.pad_height)
    crop_r = (cfg.pad_width - cfg.width) // 2    # chroma units
    crop_b = (cfg.pad_height - cfg.height) // 2
    if crop_r or crop_b:
        bw.u(1, 1)    # conformance_window_flag
        bw.ue(0)      # left
        bw.ue(crop_r)
        bw.ue(0)      # top
        bw.ue(crop_b)
    else:
        bw.u(0, 1)
    bw.ue(cfg.bit_depth - 8)   # bit_depth_luma_minus8
    bw.ue(cfg.bit_depth - 8)   # bit_depth_chroma_minus8
    bw.ue(4)          # log2_max_pic_order_cnt_lsb_minus4 (8-bit POC lsb)
    bw.u(1, 1)        # sps_sub_layer_ordering_info_present_flag
    bw.ue(4)          # sps_max_dec_pic_buffering_minus1
    bw.ue(0)          # sps_max_num_reorder_pics
    bw.ue(0)          # sps_max_latency_increase_plus1
    log2_min_cu = cfg.min_cu.bit_length() - 1
    log2_ctu = cfg.ctu_size.bit_length() - 1
    bw.ue(log2_min_cu - 3)              # log2_min_luma_coding_block_size_minus3
    bw.ue(log2_ctu - log2_min_cu)       # log2_diff_max_min
    bw.ue(cfg.min_tu.bit_length() - 1 - 2)
    bw.ue(cfg.max_tu.bit_length() - cfg.min_tu.bit_length())
    bw.ue(0)          # max_transform_hierarchy_depth_inter
    bw.ue(0)          # max_transform_hierarchy_depth_intra
    bw.u(0, 1)        # scaling_list_enabled_flag
    bw.u(0, 1)        # amp_enabled_flag
    bw.u(1 if cfg.sao else 0, 1)  # sample_adaptive_offset_enabled_flag
    bw.u(0, 1)        # pcm_enabled_flag
    bw.ue(0)          # num_short_term_ref_pic_sets
    bw.u(0, 1)        # long_term_ref_pics_present_flag
    bw.u(0, 1)        # sps_temporal_mvp_enabled_flag
    bw.u(0, 1)        # strong_intra_smoothing_enabled_flag
    bw.u(0, 1)        # vui_parameters_present_flag
    bw.u(0, 1)        # sps_extension_present_flag
    bw.align_one_then_zero()
    return nal_unit(NAL_SPS, bw.get_bytes())


def write_pps(cfg: EncoderConfig) -> bytes:
    bw = BitWriter()
    bw.ue(0)          # pps_pic_parameter_set_id
    bw.ue(0)          # pps_seq_parameter_set_id
    bw.u(0, 1)        # dependent_slice_segments_enabled_flag
    bw.u(0, 1)        # output_flag_present_flag
    bw.u(0, 3)        # num_extra_slice_header_bits
    bw.u(0, 1)        # sign_data_hiding_enabled_flag
    bw.u(0, 1)        # cabac_init_present_flag
    bw.ue(0)          # num_ref_idx_l0_default_active_minus1
    bw.ue(0)          # num_ref_idx_l1_default_active_minus1
    bw.se(cfg.qp - 26)  # init_qp_minus26
    bw.u(0, 1)        # constrained_intra_pred_flag
    bw.u(0, 1)        # transform_skip_enabled_flag
    bw.u(1 if cfg.cu_qp_delta else 0, 1)  # cu_qp_delta_enabled_flag
    if cfg.cu_qp_delta:
        bw.ue(0)      # diff_cu_qp_delta_depth (QG = CTB)
    bw.se(0)          # pps_cb_qp_offset
    bw.se(0)          # pps_cr_qp_offset
    bw.u(0, 1)        # pps_slice_chroma_qp_offsets_present_flag
    bw.u(0, 1)        # weighted_pred_flag
    bw.u(0, 1)        # weighted_bipred_flag
    bw.u(0, 1)        # transquant_bypass_enabled_flag
    bw.u(0, 1)        # tiles_enabled_flag
    bw.u(0, 1)        # entropy_coding_sync_enabled_flag
    bw.u(1, 1)        # pps_loop_filter_across_slices_enabled_flag
    bw.u(1, 1)        # deblocking_filter_control_present_flag
    bw.u(0, 1)        # deblocking_filter_override_enabled_flag
    bw.u(0 if cfg.deblock else 1, 1)  # pps_deblocking_filter_disabled_flag
    if cfg.deblock:
        bw.se(0)      # pps_beta_offset_div2
        bw.se(0)      # pps_tc_offset_div2
    bw.u(0, 1)        # pps_scaling_list_data_present_flag
    bw.u(0, 1)        # lists_modification_present_flag
    bw.ue(0)          # log2_parallel_merge_level_minus2
    bw.u(0, 1)        # slice_segment_header_extension_present_flag
    bw.u(0, 1)        # pps_extension_present_flag
    bw.align_one_then_zero()
    return nal_unit(NAL_PPS, bw.get_bytes())


def start_idr_slice(cfg: EncoderConfig, slice_qp: int) -> BitWriter:
    """Slice header for a one-slice IDR I picture; returns the BitWriter
    positioned (byte-aligned) at the start of slice data."""
    bw = BitWriter()
    bw.u(1, 1)        # first_slice_segment_in_pic_flag
    bw.u(0, 1)        # no_output_of_prior_pics_flag
    bw.ue(0)          # slice_pic_parameter_set_id
    bw.ue(2)          # slice_type = I
    if cfg.sao:
        bw.u(1, 1)    # slice_sao_luma_flag
        bw.u(1, 1)    # slice_sao_chroma_flag
    bw.se(slice_qp - cfg.qp)  # slice_qp_delta (relative to init_qp)
    if cfg.deblock or cfg.sao:
        # present when pps_loop_filter_across_slices_enabled_flag and
        # deblocking is not disabled for the slice (7.3.6.1)
        bw.u(1, 1)    # slice_loop_filter_across_slices_enabled_flag
    bw.align_one_then_zero()  # byte_alignment before slice data
    return bw


def finish_slice_nal(bw: BitWriter) -> bytes:
    return nal_unit(NAL_IDR_W_RADL, bw.get_bytes())


_HASH_LEN = {0: 16, 1: 2, 2: 4}   # MD5 / CRC / checksum bytes per plane


def write_hash_sei(h_y: bytes, h_cb: bytes, h_cr: bytes,
                   hash_type: int = 0) -> bytes:
    """decoded_picture_hash suffix SEI (D.2.19). hash_type: 0 = MD5,
    1 = CRC, 2 = checksum (HM SEIEncoder.cpp:290-310 supports all
    three)."""
    per = _HASH_LEN[hash_type]
    bw = BitWriter()
    bw.u(132, 8)                 # payload type: decoded_picture_hash
    bw.u(1 + 3 * per, 8)         # payload size
    bw.u(hash_type, 8)
    for h in (h_y, h_cb, h_cr):
        assert len(h) == per
        for byte in h:
            bw.u(byte, 8)
    bw.align_one_then_zero()     # rbsp trailing
    return nal_unit(NAL_SUFFIX_SEI, bw.get_bytes())


def _write_rps_and_refs(bw: BitWriter, n_refs: int):
    """Slice-level st_ref_pic_set: the n_refs previous pictures
    (consecutive deltas of 1), all used, + num_ref_idx override."""
    bw.u(0, 1)        # short_term_ref_pic_set_sps_flag
    # st_ref_pic_set(0): no inter-RPS prediction (idx 0)
    bw.ue(n_refs)     # num_negative_pics
    bw.ue(0)          # num_positive_pics
    for _ in range(n_refs):
        bw.ue(0)      # delta_poc_s0_minus1 (consecutive past pictures)
        bw.u(1, 1)    # used_by_curr_pic_s0_flag


def _write_ref_override(bw: BitWriter, n_refs: int, is_b: bool):
    if n_refs == 1:
        bw.u(0, 1)    # num_ref_idx_active_override_flag (PPS default 1)
    else:
        bw.u(1, 1)    # num_ref_idx_active_override_flag
        bw.ue(n_refs - 1)   # num_ref_idx_l0_active_minus1
        if is_b:
            bw.ue(n_refs - 1)   # num_ref_idx_l1_active_minus1


def start_p_slice(cfg: EncoderConfig, slice_qp: int, poc: int,
                  n_refs: int = 1) -> BitWriter:
    """Slice header for a one-slice P picture referencing the n_refs
    previous pictures (the reference LDP cfg uses 4 active refs,
    encoder_lowdelay_P_main.cfg:24)."""
    bw = BitWriter()
    bw.u(1, 1)        # first_slice_segment_in_pic_flag
    bw.ue(0)          # slice_pic_parameter_set_id
    bw.ue(1)          # slice_type = P
    bw.u(poc & 0xFF, 8)   # slice_pic_order_cnt_lsb (log2_max_poc_lsb = 8)
    _write_rps_and_refs(bw, n_refs)
    if cfg.sao:
        bw.u(1, 1)    # slice_sao_luma_flag
        bw.u(1, 1)    # slice_sao_chroma_flag
    _write_ref_override(bw, n_refs, is_b=False)
    bw.ue(0)          # five_minus_max_num_merge_cand (MaxNumMergeCand = 5)
    bw.se(slice_qp - cfg.qp)  # slice_qp_delta
    if cfg.deblock or cfg.sao:
        bw.u(1, 1)    # slice_loop_filter_across_slices_enabled_flag
    bw.align_one_then_zero()
    return bw


def finish_p_slice_nal(bw: BitWriter) -> bytes:
    from .bitstream import NAL_TRAIL_R
    return nal_unit(NAL_TRAIL_R, bw.get_bytes())


def start_b_slice(cfg: EncoderConfig, slice_qp: int, poc: int,
                  n_refs: int = 1) -> BitWriter:
    """Slice header for a one-slice low-delay B picture: both reference
    lists hold the n_refs previous pictures (negative RPS entries only,
    so RefPicList1 equals RefPicList0), uni-L0 prediction per PU; the
    reference's LDB operating point (cfg/encoder_lowdelay_main.cfg)."""
    bw = BitWriter()
    bw.u(1, 1)        # first_slice_segment_in_pic_flag
    bw.ue(0)          # slice_pic_parameter_set_id
    bw.ue(0)          # slice_type = B
    bw.u(poc & 0xFF, 8)   # slice_pic_order_cnt_lsb
    _write_rps_and_refs(bw, n_refs)
    if cfg.sao:
        bw.u(1, 1)    # slice_sao_luma_flag
        bw.u(1, 1)    # slice_sao_chroma_flag
    _write_ref_override(bw, n_refs, is_b=True)
    bw.u(1, 1)        # mvd_l1_zero_flag (no L1 MVDs are ever coded)
    bw.ue(0)          # five_minus_max_num_merge_cand (MaxNumMergeCand = 5)
    bw.se(slice_qp - cfg.qp)  # slice_qp_delta
    if cfg.deblock or cfg.sao:
        bw.u(1, 1)    # slice_loop_filter_across_slices_enabled_flag
    bw.align_one_then_zero()
    return bw
