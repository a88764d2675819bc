"""Parameter-set and slice-header writers (spec 7.3.2-7.3.6).

Host copy of x265_yuuki_asuna_tpu/bitstream/headers.py, cut to what an
8-bit 4:2:0 IPPP or fixed-mini-GOP B session writes (Main profile, flat
scaling lists, VUI timing only, one reference per list, explicit
short-term RPS, no WPP/tiles/slices, no weighted prediction or TMVP). The
bits written are the same as the JAX package's for those settings.

Reference behavior (studied, not copied): encoder/entropy.cpp codeVPS /
codeSPS / codePPS / codeProfileTier / codeSliceHeader.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from .bitio import BitWriter, wrap_nal, NAL_VPS, NAL_SPS, NAL_PPS, \
    NAL_IDR_W_RADL


@dataclass
class ProfileTierLevel:
    profile_idc: int = 1          # Main
    tier_flag: int = 0
    level_idc: int = 120          # level 4.0 (x30)
    progressive_source: int = 1
    interlaced_source: int = 0
    non_packed: int = 1
    frame_only: int = 1


@dataclass
class SPSInfo:
    width: int = 0                  # coded luma width (CU multiple)
    height: int = 0
    conf_win: Tuple[int, int, int, int] = (0, 0, 0, 0)  # l, r, t, b (luma px)
    chroma_format_idc: int = 1
    bit_depth: int = 8
    log2_max_poc_lsb: int = 8
    log2_min_cb: int = 3
    log2_diff_max_min_cb: int = 3
    log2_min_tb: int = 2
    log2_diff_max_min_tb: int = 3
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    strong_intra_smoothing: int = 1
    max_dec_pic_buffering: int = 1
    num_reorder_pics: int = 0
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    timing_info: Optional[Tuple[int, int]] = None  # (num_units_in_tick, time_scale)


@dataclass
class PPSInfo:
    init_qp: int = 26
    loop_filter_across_slices: int = 1
    deblocking_disabled: int = 0


def _profile_tier_level(bw: BitWriter, ptl: ProfileTierLevel):
    bw.write_bits(0, 2)                      # general_profile_space
    bw.write_flag(ptl.tier_flag)             # general_tier_flag
    bw.write_bits(ptl.profile_idc, 5)        # general_profile_idc
    for j in range(32):
        bw.write_flag(1 if j == ptl.profile_idc else 0)  # compatibility flags
    bw.write_flag(ptl.progressive_source)
    bw.write_flag(ptl.interlaced_source)
    bw.write_flag(ptl.non_packed)
    bw.write_flag(ptl.frame_only)
    bw.write_bits(0, 16)                     # reserved_zero_44bits
    bw.write_bits(0, 16)
    bw.write_bits(0, 12)
    bw.write_bits(ptl.level_idc, 8)          # general_level_idc


def write_vps(sps: SPSInfo) -> bytes:
    bw = BitWriter()
    bw.write_bits(0, 4)          # vps_video_parameter_set_id
    bw.write_bits(3, 2)          # vps_reserved_three_2bits
    bw.write_bits(0, 6)          # vps_reserved_zero_6bits (max_layers_minus1)
    bw.write_bits(0, 3)          # vps_max_sub_layers_minus1
    bw.write_flag(1)             # vps_temporal_id_nesting_flag
    bw.write_bits(0xFFFF, 16)    # vps_reserved_0xffff_16bits
    _profile_tier_level(bw, sps.ptl)
    bw.write_flag(1)             # vps_sub_layer_ordering_info_present_flag
    bw.write_ue(sps.max_dec_pic_buffering - 1)
    bw.write_ue(sps.num_reorder_pics)
    bw.write_ue(0 + 1)           # vps_max_latency_increase_plus1
    bw.write_bits(0, 6)          # vps_max_layer_id
    bw.write_ue(0)               # vps_num_layer_sets_minus1
    bw.write_flag(0)             # vps_timing_info_present_flag
    bw.write_flag(0)             # vps_extension_flag
    bw.rbsp_trailing_bits()
    return wrap_nal(NAL_VPS, bw.get_bytes())


def write_sps(sps: SPSInfo) -> bytes:
    bw = BitWriter()
    bw.write_bits(0, 4)          # sps_video_parameter_set_id
    bw.write_bits(0, 3)          # sps_max_sub_layers_minus1
    bw.write_flag(1)             # sps_temporal_id_nesting_flag
    _profile_tier_level(bw, sps.ptl)
    bw.write_ue(0)               # sps_seq_parameter_set_id
    bw.write_ue(sps.chroma_format_idc)
    bw.write_ue(sps.width)
    bw.write_ue(sps.height)
    l, r, t, b = sps.conf_win
    enabled = any((l, r, t, b))
    bw.write_flag(enabled)
    if enabled:                  # offsets in 4:2:0 chroma units
        bw.write_ue(l >> 1)
        bw.write_ue(r >> 1)
        bw.write_ue(t >> 1)
        bw.write_ue(b >> 1)
    bw.write_ue(sps.bit_depth - 8)
    bw.write_ue(sps.bit_depth - 8)
    bw.write_ue(sps.log2_max_poc_lsb - 4)
    bw.write_flag(1)             # sps_sub_layer_ordering_info_present_flag
    bw.write_ue(sps.max_dec_pic_buffering - 1)
    bw.write_ue(sps.num_reorder_pics)
    bw.write_ue(0 + 1)           # sps_max_latency_increase_plus1
    bw.write_ue(sps.log2_min_cb - 3)
    bw.write_ue(sps.log2_diff_max_min_cb)
    bw.write_ue(sps.log2_min_tb - 2)
    bw.write_ue(sps.log2_diff_max_min_tb)
    bw.write_ue(sps.max_transform_hierarchy_depth_inter)
    bw.write_ue(sps.max_transform_hierarchy_depth_intra)
    bw.write_flag(0)             # scaling_list_enabled_flag
    bw.write_flag(0)             # amp_enabled_flag
    bw.write_flag(0)             # sample_adaptive_offset_enabled_flag
    bw.write_flag(0)             # pcm_enabled_flag
    bw.write_ue(0)               # num_short_term_ref_pic_sets
    bw.write_flag(0)             # long_term_ref_pics_present_flag
    bw.write_flag(0)             # sps_temporal_mvp_enabled_flag
    bw.write_flag(sps.strong_intra_smoothing)
    vui_present = sps.timing_info is not None
    bw.write_flag(1 if vui_present else 0)
    if vui_present:
        _write_vui(bw, sps)
    bw.write_flag(0)             # sps_extension_present_flag
    bw.rbsp_trailing_bits()
    return wrap_nal(NAL_SPS, bw.get_bytes())


def _write_vui(bw: BitWriter, sps: SPSInfo):
    bw.write_flag(0)             # aspect_ratio_info_present_flag
    bw.write_flag(0)             # overscan_info_present_flag
    bw.write_flag(0)             # video_signal_type_present_flag
    bw.write_flag(0)             # chroma_loc_info_present_flag
    bw.write_flag(0)             # neutral_chroma_indication_flag
    bw.write_flag(0)             # field_seq_flag
    bw.write_flag(0)             # frame_field_info_present_flag
    bw.write_flag(0)             # default_display_window_flag
    bw.write_flag(1)             # vui_timing_info_present_flag
    bw.write_bits(sps.timing_info[0], 32)
    bw.write_bits(sps.timing_info[1], 32)
    bw.write_flag(0)             # poc_proportional_to_timing_flag
    bw.write_flag(0)             # vui_hrd_parameters_present_flag
    bw.write_flag(0)             # bitstream_restriction_flag


def write_pps(pps: PPSInfo) -> bytes:
    bw = BitWriter()
    bw.write_ue(0)               # pps_pic_parameter_set_id
    bw.write_ue(0)               # pps_seq_parameter_set_id
    bw.write_flag(0)             # dependent_slice_segments_enabled_flag
    bw.write_flag(0)             # output_flag_present_flag
    bw.write_bits(0, 3)          # num_extra_slice_header_bits
    bw.write_flag(0)             # sign_data_hiding_enabled_flag
    bw.write_flag(0)             # cabac_init_present_flag
    bw.write_ue(0)               # num_ref_idx_l0_default_active_minus1
    bw.write_ue(0)               # num_ref_idx_l1_default_active_minus1
    bw.write_se(pps.init_qp - 26)
    bw.write_flag(0)             # constrained_intra_pred_flag
    bw.write_flag(0)             # transform_skip_enabled_flag
    bw.write_flag(0)             # cu_qp_delta_enabled_flag
    bw.write_se(0)               # pps_cb_qp_offset
    bw.write_se(0)               # pps_cr_qp_offset
    bw.write_flag(0)             # pps_slice_chroma_qp_offsets_present_flag
    bw.write_flag(0)             # weighted_pred_flag
    bw.write_flag(0)             # weighted_bipred_flag
    bw.write_flag(0)             # transquant_bypass_enabled_flag
    bw.write_flag(0)             # tiles_enabled_flag
    bw.write_flag(0)             # entropy_coding_sync_enabled_flag
    bw.write_flag(pps.loop_filter_across_slices)
    bw.write_flag(1 if pps.deblocking_disabled else 0)
    if pps.deblocking_disabled:  # deblocking_filter_control_present
        bw.write_flag(0)         # deblocking_filter_override_enabled_flag
        bw.write_flag(1)         # pps_deblocking_filter_disabled_flag
    bw.write_flag(0)             # pps_scaling_list_data_present_flag
    bw.write_flag(0)             # lists_modification_present_flag
    bw.write_ue(0)               # log2_parallel_merge_level_minus2
    bw.write_flag(0)             # slice_segment_header_extension_present_flag
    bw.write_flag(0)             # pps_extension_present_flag
    bw.rbsp_trailing_bits()
    return wrap_nal(NAL_PPS, bw.get_bytes())


def write_slice_header(sps: SPSInfo, pps: PPSInfo, slice_type: int,
                       slice_qp: int, *, nal_type: int = NAL_IDR_W_RADL,
                       poc: int = 0, ref_poc_delta: int = 1,
                       pos_poc_delta: int = 0, rps: Optional[Tuple] = None,
                       max_merge: int = 3) -> BitWriter:
    """Returns a BitWriter positioned after byte_alignment() — ready for the
    caller to append CABAC slice data. slice_type: 0=B 1=P 2=I (one slice
    per picture, one reference per list).

    The short-term RPS (spec 7.3.7) holds the L0 reference ref_poc_delta
    before the picture and, when pos_poc_delta is set, the L1 reference
    that far after it, both used by the picture. rps overrides that:
    (negatives, positives), each a list of (poc distance, used_by_curr)
    nearest first, e.g. a B-pyramid leaf that keeps an unused later
    anchor in its RPS."""
    bw = BitWriter()
    bw.write_flag(1)                         # first_slice_segment_in_pic_flag
    if 16 <= nal_type <= 23:                 # IRAP
        bw.write_flag(0)                     # no_output_of_prior_pics_flag
    bw.write_ue(0)                           # slice_pic_parameter_set_id
    bw.write_ue(slice_type)
    if nal_type not in (19, 20):             # not IDR
        bw.write_bits(poc & ((1 << sps.log2_max_poc_lsb) - 1),
                      sps.log2_max_poc_lsb)
        bw.write_flag(0)                     # short_term_ref_pic_set_sps_flag
        if rps is None:
            neg = [(ref_poc_delta, 1)]
            pos = [(pos_poc_delta, 1)] if pos_poc_delta else []
        else:
            neg, pos = rps
        bw.write_ue(len(neg))                # num_negative_pics
        bw.write_ue(len(pos))                # num_positive_pics
        for pics in (neg, pos):
            prev = 0
            for delta, used in pics:
                bw.write_ue(delta - prev - 1)    # delta_poc_s{0,1}_minus1
                bw.write_flag(used)              # used_by_curr_pic_s{0,1}
                prev = delta
    if slice_type != 2:                      # P / B
        bw.write_flag(0)                     # num_ref_idx_active_override_flag
        if slice_type == 0:
            bw.write_flag(0)                 # mvd_l1_zero_flag
        bw.write_ue(5 - max_merge)           # five_minus_max_num_merge_cand
    bw.write_se(slice_qp - pps.init_qp)
    if pps.loop_filter_across_slices and not pps.deblocking_disabled:
        bw.write_flag(1)                     # slice_loop_filter_across_slices
    # byte_alignment(): alignment_bit_equal_to_one, then zero bits to boundary
    bw.write_bits(1, 1)
    bw.write_align_zero()
    return bw
