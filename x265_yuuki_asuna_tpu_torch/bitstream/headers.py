"""Parameter-set and slice-header writers (spec 7.3.2-7.3.6).

Host copy of x265_yuuki_asuna_tpu/bitstream/headers.py, cut to what a
4:2:0 intra, IPPP or B session or a 4:4:4 intra session writes (Main,
Main10, or Main12 and Main 4:4:4 with the Range Extensions' constraint
flags; flat or signalled scaling lists
(SPS), VUI timing, HRD, signal type and chroma location only, one
reference per list but one or two L0 references in P slices (the
active-reference override), explicit short-term RPS, temporal MV
prediction, explicit weighted prediction of P slices, transquant bypass
(lossless), WPP's entry points and a picture's slices by their segment
address, no tiles or weighted bi-prediction; deblocking and SAO on or
off, deblocking at the default offsets). The bits written are the same as the JAX package's for
those settings.

Reference behavior (studied, not copied): encoder/entropy.cpp codeVPS /
codeSPS / codePPS / codeProfileTier / codeSliceHeader.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

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
    # the Range Extensions' constraints (profile_idc 4: Main12, Main
    # 4:4:4): the bit depth and the chroma format (1: at most 4:2:0, 2:
    # at most 4:2:2, 3: 4:4:4)
    bit_depth_constraint: int = 8
    chroma_constraint: int = 1


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
    sao_enabled: int = 0
    # ScalingListData (bitstream/scaling.py) or None (flat lists)
    scaling_list: object = None
    temporal_mvp: int = 0           # sps_temporal_mvp_enabled_flag
    strong_intra_smoothing: int = 1
    max_dec_pic_buffering: int = 1
    num_reorder_pics: int = 0
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    timing_info: Optional[Tuple[int, int]] = None  # (num_units_in_tick, time_scale)
    # HRD in the VUI (spec E.2.2): (max_bitrate_bps, cpb_size_bits,
    # cbr_flag), written with timing_info
    hrd: Optional[Tuple[int, int, int]] = None
    # VUI video signal type and chroma location (the CLI's --range,
    # --colorprim / --transfer / --colormatrix and --chromaloc)
    video_full_range: int = 0
    colour_description: Optional[Tuple[int, int, int]] = None
    chroma_loc: Optional[int] = None    # chroma_sample_loc_type (0..5)


@dataclass
class PPSInfo:
    init_qp: int = 26
    loop_filter_across_slices: int = 1
    deblocking_disabled: int = 0
    sign_hiding: int = 0
    cu_qp_delta: int = 0             # per-CU QP (AQ / cuTree)
    diff_cu_qp_delta_depth: int = 0  # quantization group = CTU
    weighted_pred: int = 0           # P slices carry a pred_weight_table
    transquant_bypass: int = 0       # lossless CUs may bypass (signalled)
    entropy_coding_sync: int = 0     # WPP: one substream per CTU row


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
    if ptl.profile_idc == 4:
        # Range Extensions (Main12, Main 4:4:4): constraint flags in place
        # of the reserved_zero_44bits (spec 7.3.3 / A.3.5)
        bd = ptl.bit_depth_constraint
        cc = ptl.chroma_constraint
        bw.write_flag(1)                     # general_max_12bit_constraint
        bw.write_flag(1 if bd <= 10 else 0)  # max_10bit
        bw.write_flag(1 if bd <= 8 else 0)   # max_8bit
        bw.write_flag(1 if cc <= 2 else 0)   # max_422chroma
        bw.write_flag(1 if cc <= 1 else 0)   # max_420chroma
        bw.write_flag(0)                     # max_monochrome
        bw.write_flag(0)                     # intra
        bw.write_flag(0)                     # one_picture_only
        bw.write_flag(1)                     # lower_bit_rate
        bw.write_bits(0, 17)                 # reserved_zero_34bits
        bw.write_bits(0, 17)
        bw.write_flag(0)                     # reserved_zero_bit (inbld)
    else:
        bw.write_bits(0, 16)                 # reserved_zero_44bits
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
    if sps.chroma_format_idc == 3:
        bw.write_flag(0)         # separate_colour_plane_flag
    bw.write_ue(sps.width)
    bw.write_ue(sps.height)
    l, r, t, b = sps.conf_win
    enabled = any((l, r, t, b))
    bw.write_flag(enabled)
    if enabled:                  # offsets in chroma sample units
        hs = 1 if sps.chroma_format_idc in (1, 2) else 0
        vs = 1 if sps.chroma_format_idc == 1 else 0
        bw.write_ue(l >> hs)
        bw.write_ue(r >> hs)
        bw.write_ue(t >> vs)
        bw.write_ue(b >> vs)
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
    sld = sps.scaling_list
    bw.write_flag(sld is not None)   # scaling_list_enabled_flag
    if sld is not None:
        from .scaling import write_scaling_list_data
        default = all(sld.is_default(sz, k) for sz in range(4)
                      for k in range(6))
        bw.write_flag(not default)   # sps_scaling_list_data_present_flag
        if not default:
            write_scaling_list_data(bw, sld)
    bw.write_flag(0)             # amp_enabled_flag
    bw.write_flag(sps.sao_enabled)
    bw.write_flag(0)             # pcm_enabled_flag
    bw.write_ue(0)               # num_short_term_ref_pic_sets
    bw.write_flag(0)             # long_term_ref_pics_present_flag
    bw.write_flag(sps.temporal_mvp)  # sps_temporal_mvp_enabled_flag
    bw.write_flag(sps.strong_intra_smoothing)
    vui_present = (sps.timing_info is not None or sps.video_full_range
                   or sps.colour_description or sps.chroma_loc is not None)
    bw.write_flag(1 if vui_present else 0)
    if vui_present:
        _write_vui(bw, sps)
    bw.write_flag(0)             # sps_extension_present_flag
    bw.rbsp_trailing_bits()
    return wrap_nal(NAL_SPS, bw.get_bytes())


def _write_vui(bw: BitWriter, sps: SPSInfo):
    bw.write_flag(0)             # aspect_ratio_info_present_flag
    bw.write_flag(0)             # overscan_info_present_flag
    if sps.video_full_range or sps.colour_description:
        bw.write_flag(1)         # video_signal_type_present_flag
        bw.write_bits(5, 3)      # video_format unknown
        bw.write_flag(sps.video_full_range)
        bw.write_flag(1 if sps.colour_description else 0)
        if sps.colour_description:
            for v in sps.colour_description:   # primaries, transfer, matrix
                bw.write_bits(v, 8)
    else:
        bw.write_flag(0)         # video_signal_type_present_flag
    if sps.chroma_loc is not None:
        bw.write_flag(1)         # chroma_loc_info_present_flag
        bw.write_ue(sps.chroma_loc)
        bw.write_ue(sps.chroma_loc)
    else:
        bw.write_flag(0)         # chroma_loc_info_present_flag
    bw.write_flag(0)             # neutral_chroma_indication_flag
    bw.write_flag(0)             # field_seq_flag
    bw.write_flag(0)             # frame_field_info_present_flag
    bw.write_flag(0)             # default_display_window_flag
    if sps.timing_info:
        bw.write_flag(1)         # vui_timing_info_present_flag
        bw.write_bits(sps.timing_info[0], 32)
        bw.write_bits(sps.timing_info[1], 32)
        bw.write_flag(0)         # poc_proportional_to_timing_flag
        if sps.hrd:
            bw.write_flag(1)     # vui_hrd_parameters_present_flag
            _write_hrd(bw, sps)
        else:
            bw.write_flag(0)     # vui_hrd_parameters_present_flag
    else:
        bw.write_flag(0)         # vui_timing_info_present_flag
    bw.write_flag(0)             # bitstream_restriction_flag


# scale exponents (spec E.2.2): value = (v + 1) << (6 | 4 + scale)
HRD_BITRATE_SCALE = 4            # bitrate units of 2^(6+4) = 1024 bps
HRD_CPB_SCALE = 6                # cpb units of 2^(4+6) = 1024 bits


def hrd_units(sps):
    """(bit_rate_value_minus1, cpb_size_value_minus1, cbr_flag) of
    sps.hrd, each rate rounded up to its unit."""
    maxrate_bps, cpb_bits, cbr = sps.hrd
    br = max(-(-maxrate_bps // (1 << (6 + HRD_BITRATE_SCALE))), 1)
    cpb = max(-(-cpb_bits // (1 << (4 + HRD_CPB_SCALE))), 1)
    return br - 1, cpb - 1, cbr


def _write_hrd(bw: BitWriter, sps):
    """hrd_parameters(1, 0): NAL HRD only, one sub-layer, one CPB, no
    sub-picture timing, 24-bit delay fields."""
    br_m1, cpb_m1, cbr = hrd_units(sps)
    bw.write_flag(1)             # nal_hrd_parameters_present_flag
    bw.write_flag(0)             # vcl_hrd_parameters_present_flag
    bw.write_flag(0)             # sub_pic_hrd_params_present_flag
    bw.write_bits(HRD_BITRATE_SCALE, 4)
    bw.write_bits(HRD_CPB_SCALE, 4)
    bw.write_bits(23, 5)         # initial_cpb_removal_delay_length_minus1
    bw.write_bits(23, 5)         # au_cpb_removal_delay_length_minus1
    bw.write_bits(23, 5)         # dpb_output_delay_length_minus1
    bw.write_flag(0)             # fixed_pic_rate_general_flag[0]
    bw.write_flag(0)             # fixed_pic_rate_within_cvs_flag[0]
    bw.write_flag(0)             # low_delay_hrd_flag[0]
    bw.write_ue(0)               # cpb_cnt_minus1[0]
    bw.write_ue(br_m1)           # bit_rate_value_minus1
    bw.write_ue(cpb_m1)          # cpb_size_value_minus1
    bw.write_flag(cbr)           # cbr_flag


def write_pps(pps: PPSInfo) -> bytes:
    bw = BitWriter()
    bw.write_ue(0)               # pps_pic_parameter_set_id
    bw.write_ue(0)               # pps_seq_parameter_set_id
    bw.write_flag(0)             # dependent_slice_segments_enabled_flag
    bw.write_flag(0)             # output_flag_present_flag
    bw.write_bits(0, 3)          # num_extra_slice_header_bits
    bw.write_flag(pps.sign_hiding)   # sign_data_hiding_enabled_flag
    bw.write_flag(0)             # cabac_init_present_flag
    bw.write_ue(0)               # num_ref_idx_l0_default_active_minus1
    bw.write_ue(0)               # num_ref_idx_l1_default_active_minus1
    bw.write_se(pps.init_qp - 26)
    bw.write_flag(0)             # constrained_intra_pred_flag
    bw.write_flag(0)             # transform_skip_enabled_flag
    bw.write_flag(pps.cu_qp_delta)   # cu_qp_delta_enabled_flag
    if pps.cu_qp_delta:
        bw.write_ue(pps.diff_cu_qp_delta_depth)
    bw.write_se(0)               # pps_cb_qp_offset
    bw.write_se(0)               # pps_cr_qp_offset
    bw.write_flag(0)             # pps_slice_chroma_qp_offsets_present_flag
    bw.write_flag(pps.weighted_pred)  # weighted_pred_flag
    bw.write_flag(0)             # weighted_bipred_flag
    bw.write_flag(pps.transquant_bypass)  # transquant_bypass_enabled_flag
    bw.write_flag(0)             # tiles_enabled_flag
    bw.write_flag(pps.entropy_coding_sync)  # entropy_coding_sync_enabled
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
                       max_merge: int = 3, sao: bool = False,
                       weights: Optional[dict] = None,
                       slice_addr: int = 0, slice_addr_bits: int = 0,
                       entry_point_offsets: Optional[List[int]] = None,
                       num_ref_l0: int = 1) -> BitWriter:
    """Returns a BitWriter positioned after byte_alignment() — ready for the
    caller to append CABAC slice data. slice_type: 0=B 1=P 2=I (one slice
    per picture, one reference per list but num_ref_l0 active L0
    references in a P slice: other than 1 it overrides the PPS's default
    count, and under TMVP the collocated picture is L0 index 0).

    The short-term RPS (spec 7.3.7) holds the L0 reference ref_poc_delta
    before the picture and, when pos_poc_delta is set, the L1 reference
    that far after it, both used by the picture. rps overrides that:
    (negatives, positives), each a list of (poc distance, used_by_curr)
    nearest first, e.g. a B-pyramid leaf that keeps an unused later
    anchor in its RPS. sao: the slice's SAO luma and chroma flags (written
    when the SPS enables SAO). weights: the P slice's explicit weights
    (see _write_pred_weight_table); with the PPS's weighted_pred_flag
    every P slice carries the table, all flags 0 when weights is None.
    slice_addr: the slice's first CTU (raster index; 0 is the picture's
    first slice), written in slice_addr_bits bits. entry_point_offsets:
    under the PPS's entropy_coding_sync, the byte sizes of every
    substream but the last. With the SPS's temporal_mvp every non-IDR
    slice enables temporal MV prediction."""
    bw = BitWriter()
    first = slice_addr == 0
    bw.write_flag(first)                     # first_slice_segment_in_pic_flag
    if 16 <= nal_type <= 23:                 # IRAP
        bw.write_flag(0)                     # no_output_of_prior_pics_flag
    bw.write_ue(0)                           # slice_pic_parameter_set_id
    if not first:
        bw.write_bits(slice_addr, slice_addr_bits)  # slice_segment_address
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
        if sps.temporal_mvp:
            bw.write_flag(1)                 # slice_temporal_mvp_enabled_flag
    if sps.sao_enabled:
        bw.write_flag(int(sao))              # slice_sao_luma_flag
        bw.write_flag(int(sao))              # slice_sao_chroma_flag
    if slice_type != 2:                      # P / B
        bw.write_flag(num_ref_l0 != 1)       # num_ref_idx_active_override_flag
        if num_ref_l0 != 1:
            bw.write_ue(num_ref_l0 - 1)      # num_ref_idx_l0_active_minus1
            if slice_type == 0:
                bw.write_ue(0)               # num_ref_idx_l1_active_minus1
        if slice_type == 0:
            bw.write_flag(0)                 # mvd_l1_zero_flag
        if sps.temporal_mvp and num_ref_l0 > 1:
            # collocated_from_l0 is inferred (P); index 0 is the nearest
            bw.write_ue(0)                   # collocated_ref_idx
        if pps.weighted_pred and slice_type == 1:
            _write_pred_weight_table(bw, weights or {})
        bw.write_ue(5 - max_merge)           # five_minus_max_num_merge_cand
    bw.write_se(slice_qp - pps.init_qp)
    if pps.loop_filter_across_slices and (sao or
                                          not pps.deblocking_disabled):
        bw.write_flag(1)                     # slice_loop_filter_across_slices
    if pps.entropy_coding_sync:
        offsets = entry_point_offsets or []
        bw.write_ue(len(offsets))            # num_entry_point_offsets
        if offsets:
            olen = max(1, max(o - 1 for o in offsets).bit_length())
            bw.write_ue(olen - 1)            # offset_len_minus1
            for o in offsets:
                bw.write_bits(o - 1, olen)   # entry_point_offset_minus1
    # byte_alignment(): alignment_bit_equal_to_one, then zero bits to boundary
    bw.write_bits(1, 1)
    bw.write_align_zero()
    return bw


def _write_pred_weight_table(bw: BitWriter, weights: dict) -> None:
    """pred_weight_table (spec 7.3.6.3) of one L0 reference. weights:
    {"denom": log2 denominator (default 6), "luma" / "cb" / "cr": (w, o)
    or absent}; an absent luma weight codes flag 0, and with one chroma
    weight the other codes the default (1 << denom, 0)."""
    denom = weights.get("denom", 6)
    bw.write_ue(denom)                       # luma_log2_weight_denom
    bw.write_se(0)                           # delta_chroma_log2_weight_denom
    luma, cb, cr = (weights.get(k) for k in ("luma", "cb", "cr"))
    bw.write_flag(1 if luma else 0)          # luma_weight_l0_flag[0]
    bw.write_flag(1 if (cb or cr) else 0)    # chroma_weight_l0_flag[0]
    if luma:
        w, o = luma
        bw.write_se(w - (1 << denom))        # delta_luma_weight_l0
        bw.write_se(o)                       # luma_offset_l0
    if cb or cr:
        for comp in (cb, cr):
            w, o = comp or ((1 << denom), 0)
            bw.write_se(w - (1 << denom))    # delta_chroma_weight_l0
            bw.write_se(o + ((128 * w) >> denom) - 128)  # delta_chroma_offset
