"""The encoder's parameters: x265's config surface (port's copy of
x265_yuuki_asuna_tpu/utils/param.py, whole: Param, RateControlParam,
VUIParam, Zone, the presets and tunes, the option table, param_parse,
check_params and param_to_string, plain Python).

Behavioral parity targets (reference, studied not copied): common/param.cpp
x265_param_default, x265_param_default_preset, x265_param_parse and
x265_check_params.

Thread-count style options (pools, frame threads, lookahead threads) and
pmode / pme are kept so option names, CSV columns and preset semantics
line up with the reference; the sessions do not read them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Constants (mirror source/x265.h public enums)
# ---------------------------------------------------------------------------

# Chroma sampling formats
CSP_I400 = 0
CSP_I420 = 1
CSP_I422 = 2
CSP_I444 = 3

CSP_NAMES = {"i400": CSP_I400, "i420": CSP_I420, "i422": CSP_I422, "i444": CSP_I444,
             "400": CSP_I400, "420": CSP_I420, "422": CSP_I422, "444": CSP_I444}

# Rate control modes
RC_ABR = 0
RC_CQP = 1
RC_CRF = 2

# Motion search methods (x265.h X265_*_SEARCH)
ME_DIA = 0
ME_HEX = 1
ME_UMH = 2
ME_STAR = 3
ME_SEA = 4
ME_FULL = 5
ME_NAMES = ["dia", "hex", "umh", "star", "sea", "full"]

# B-adapt
B_ADAPT_NONE = 0
B_ADAPT_FAST = 1
B_ADAPT_TRELLIS = 2

# AQ modes
AQ_NONE = 0
AQ_VARIANCE = 1
AQ_AUTO_VARIANCE = 2
AQ_AUTO_VARIANCE_BIASED = 3
AQ_EDGE = 4

# Decoded picture hash SEI types
HASH_NONE = 0
HASH_MD5 = 1
HASH_CRC = 2
HASH_CHECKSUM = 3

# Slice types (x265.h X265_TYPE_*)
TYPE_AUTO = 0
TYPE_IDR = 1
TYPE_I = 2
TYPE_P = 3
TYPE_BREF = 4
TYPE_B = 5

QP_MAX_SPEC = 51
QP_MAX_MAX = 69
MAX_FRAME_DUPLICATION = 32
MAX_LOG2_POC_LSB = 16

PRESET_NAMES = ["ultrafast", "superfast", "veryfast", "faster", "fast",
                "medium", "slow", "slower", "veryslow", "placebo"]
TUNE_NAMES = ["psnr", "ssim", "grain", "zerolatency", "fastdecode", "animation"]


class ParamError(ValueError):
    """Raised on invalid option names or values (x265_param_parse error codes)."""


def _bool(value) -> int:
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, (int, float)):
        return int(bool(value))
    v = str(value).strip().lower()
    if v in ("1", "true", "yes", "on", ""):
        return 1
    if v in ("0", "false", "no", "off"):
        return 0
    raise ParamError(f"invalid boolean value '{value}'")


@dataclass
class Zone:
    start_frame: int = 0
    end_frame: int = 0
    b_force_qp: int = 0
    qp: int = 0
    bitrate_factor: float = 1.0
    zone_param: Optional["Param"] = None


@dataclass
class RateControlParam:
    """Mirror of x265_param.rc (x265.h:1329-1493)."""
    rate_control_mode: int = RC_CRF
    qp: int = 32
    bitrate: int = 0                    # kbps (ABR)
    q_compress: float = 0.6
    ip_factor: float = 1.4
    pb_factor: float = 1.3
    rf_constant: float = 28.0
    qp_step: int = 4
    aq_mode: int = AQ_AUTO_VARIANCE
    aq_strength: float = 1.0
    hevc_aq: int = 0
    qp_adaptation_range: float = 1.0
    vbv_max_bitrate: int = 0
    vbv_buffer_size: int = 0
    vbv_buffer_init: float = 0.9
    cu_tree: int = 1
    rf_constant_max: float = 0.0
    rf_constant_min: float = 0.0
    b_stat_write: int = 0
    b_stat_read: int = 0
    stat_file_name: Optional[str] = None
    qblur: float = 0.5
    complexity_blur: float = 20.0
    b_enable_slow_first_pass: int = 1
    zone_count: int = 0
    zonefile_count: int = 0
    zones: List[Zone] = field(default_factory=list)
    lambda_file_name: Optional[str] = None
    b_strict_cbr: int = 0
    qg_size: int = 32
    b_enable_grain: int = 0
    qp_max: int = QP_MAX_MAX
    qp_min: int = 0
    b_enable_const_vbv: int = 0


@dataclass
class VUIParam:
    aspect_ratio_idc: int = 0
    sar_width: int = 0
    sar_height: int = 0
    b_enable_overscan_info_present_flag: int = 0
    b_enable_overscan_appropriate_flag: int = 0
    b_enable_video_signal_type_present_flag: int = 0
    video_format: int = 5
    b_enable_video_full_range_flag: int = 0
    b_enable_color_description_present_flag: int = 0
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coeffs: int = 2
    b_enable_chroma_loc_info_present_flag: int = 0
    chroma_sample_loc_type_top_field: int = 0
    chroma_sample_loc_type_bottom_field: int = 0
    b_enable_default_display_window_flag: int = 0
    def_disp_win_left_offset: int = 0
    def_disp_win_right_offset: int = 0
    def_disp_win_top_offset: int = 0
    def_disp_win_bottom_offset: int = 0


@dataclass
class Param:
    """The port's `x265_param` (x265.h:756-1950)."""

    # --- parallelism (x265.h:763-841): kept for parity, not read
    frame_num_threads: int = 0          # → frame-pipeline depth (0 = auto)
    num_pools: Optional[str] = None     # → device count selector
    b_enable_wavefront: int = 1
    b_distribute_mode_analysis: int = 0  # accepted and ignored
    b_distribute_motion_estimation: int = 0
    lookahead_slices: int = 8
    lookahead_threads: int = 0

    # --- logging / stats
    log_level: int = 2                  # X265_LOG_INFO
    b_log_cu_stats: int = 0
    b_enable_psnr: int = 0
    b_enable_ssim: int = 0
    csv_fn: Optional[str] = None
    csv_log_level: int = 0

    # --- internal picture spec
    source_width: int = 0
    source_height: int = 0
    fps_num: int = 25
    fps_denom: int = 1
    internal_bit_depth: int = 8
    source_bit_depth: int = 8
    internal_csp: int = CSP_I420
    interlace_mode: int = 0
    total_frames: int = 0

    # --- profile/tier/level
    level_idc: int = 0
    b_high_tier: int = 1
    uhd_bluray: int = 0
    max_luma_level: int = 0
    b_allow_non_conformance: int = 0

    # --- bitstream options
    b_annexb: int = 1
    b_repeat_headers: int = 0
    b_enable_access_unit_delimiters: int = 0
    b_emit_hrd_sei: int = 0
    b_emit_info_sei: int = 1
    decoded_picture_hash_sei: int = 0
    b_enable_temporal_sub_layers: int = 0
    log2_max_poc_lsb: int = 8
    max_slices: int = 1
    b_emit_vui_timing_info: int = 1
    b_emit_vui_hrd_info: int = 1
    b_opt_qp_pps: int = 0
    b_opt_ref_list_length_pps: int = 0
    b_opt_cu_delta_qp: int = 0
    b_emit_idr_recovery_sei: int = 0

    # --- GOP / lookahead
    b_open_gop: int = 1
    keyframe_min: int = 0
    keyframe_max: int = 250
    gop_lookahead: int = 0
    bframes: int = 4
    lookahead_depth: int = 20
    b_frame_adaptive: int = B_ADAPT_TRELLIS
    b_bpyramid: int = 1
    b_frame_bias: int = 0
    scenecut_threshold: int = 40
    b_hist_based_scenecut: int = 0
    edge_transition_threshold: float = 0.03
    scenecut_bias: float = 5.0
    radl: int = 0
    b_enable_fades: int = 0
    b_enable_scenecut_aware_qp: int = 0
    fwd_scenecut_window: int = 500
    fwd_ref_qp_delta: float = 5.0
    fwd_nonref_qp_delta: float = -1.0
    bwd_scenecut_window: int = 100
    bwd_ref_qp_delta: float = -1.0
    bwd_nonref_qp_delta: float = -1.0
    b_intra_refresh: int = 0

    # --- CU definitions
    max_cu_size: int = 64
    min_cu_size: int = 8
    b_enable_rect_inter: int = 0
    b_enable_amp: int = 0
    limit_modes: int = 0
    limit_references: int = 1

    # --- TU / RQT
    max_tu_size: int = 32
    tu_qt_max_inter_depth: int = 1
    tu_qt_max_intra_depth: int = 1
    limit_tu: int = 0
    rdoq_level: int = 0
    b_enable_sign_hiding: int = 1
    b_enable_transform_skip: int = 0
    b_enable_tskip_fast: int = 0
    noise_reduction_intra: int = 0
    noise_reduction_inter: int = 0

    # --- intra tools
    b_enable_constrained_intra: int = 0
    b_enable_strong_intra_smoothing: int = 1
    b_enable_fast_intra: int = 0
    b_intra_in_bframes: int = 1

    # --- inter tools
    search_method: int = ME_HEX
    subpel_refine: int = 2
    search_range: int = 57
    max_num_merge_cand: int = 3
    b_enable_weighted_pred: int = 1
    b_enable_weighted_bipred: int = 0
    b_enable_early_skip: int = 1
    recursion_skip_mode: int = 1
    edge_var_threshold: float = 0.05
    max_num_references: int = 3
    b_enable_temporal_mvp: int = 1
    b_enable_hme: int = 0
    hme_search_method: Tuple[int, int, int] = (ME_HEX, ME_UMH, ME_UMH)
    hme_range: Tuple[int, int, int] = (16, 32, 48)
    b_source_reference_estimation: int = 0
    dynamic_rd: float = 0.0
    b_enable_split_rd_skip: int = 0

    # --- analysis
    rd_level: int = 3
    psy_rd: float = 2.0
    psy_rdoq: float = 0.0
    rd_penalty: int = 0
    b_enable_rd_refine: int = 0
    b_lossless: int = 0
    b_cu_lossless: int = 0
    analysis_save: Optional[str] = None
    analysis_load: Optional[str] = None
    analysis_save_reuse_level: int = 0
    analysis_load_reuse_level: int = 0
    scale_factor: int = 0
    intra_refine: int = 0
    inter_refine: int = 0
    mv_refine: int = 1
    b_dynamic_refine: int = 0
    b_ssim_rd: int = 0

    # --- loop filters
    b_enable_loop_filter: int = 1
    deblocking_filter_tc_offset: int = 0
    deblocking_filter_beta_offset: int = 0
    b_enable_sao: int = 1
    b_sao_non_deblocked: int = 0
    b_limit_sao: int = 0
    selective_sao: int = 0

    # --- QP offsets
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0

    # --- rate control + VUI sub-structs
    rc: RateControlParam = field(default_factory=RateControlParam)
    vui: VUIParam = field(default_factory=VUIParam)

    # --- VBV extras
    vbv_buffer_end: float = 0.0
    vbv_end_frame_adjust: float = 0.0
    min_vbv_fullness: float = 50.0
    max_vbv_fullness: float = 80.0

    # --- HDR / SEI tail
    master_display: Optional[str] = None
    max_cll: int = 0
    max_fall: int = 0
    b_emit_hdr10_sei: int = 0
    b_hdr10_opt: int = 0
    b_emit_cll_sei: int = 0
    min_luma: int = 0
    max_luma: int = 255
    chunk_start: int = 0
    chunk_end: int = 0
    b_enable_frame_duplication: int = 0
    dup_threshold: int = 70
    b_enable_temporal_filter: int = 0
    temporal_filter_strength: float = 0.95
    film_grain: Optional[str] = None

    # --- misc
    b_enable_sea_integral: int = 0
    force_flush: int = 0
    b_disable_lookahead: int = 0
    b_copy_pic_to_frame: int = 1
    reconfig_window_size: int = 0

    # ------------------------------------------------------------------
    # Derived geometry helpers
    # ------------------------------------------------------------------
    @property
    def qp_max_allowed(self) -> int:
        return QP_MAX_SPEC + (self.internal_bit_depth - 8) * 6

    def chroma_shift(self) -> Tuple[int, int]:
        """(hshift, wshift) of chroma planes relative to luma."""
        return {CSP_I400: (0, 0), CSP_I420: (1, 1),
                CSP_I422: (0, 1), CSP_I444: (0, 0)}[self.internal_csp]

    def copy(self) -> "Param":
        return dataclasses.replace(
            self,
            rc=dataclasses.replace(self.rc, zones=list(self.rc.zones)),
            vui=dataclasses.replace(self.vui),
        )


# ---------------------------------------------------------------------------
# Presets & tunes  (values from the public preset table, doc/reST/presets.rst)
# ---------------------------------------------------------------------------

# Each preset entry only lists deltas from the "medium" defaults above,
# matching x265_param_default_preset (param.cpp:382).
_PRESETS: Dict[str, Dict[str, object]] = {
    "ultrafast": dict(
        max_cu_size=32, min_cu_size=16, bframes=3, b_frame_adaptive=B_ADAPT_NONE,
        rc__cu_tree=0, scenecut_threshold=0, lookahead_depth=5, lookahead_slices=8,
        b_enable_wavefront=1, search_method=ME_DIA, subpel_refine=0,
        max_num_references=1, rd_level=2, b_enable_loop_filter=0, b_enable_sao=0,
        b_enable_weighted_pred=0, b_enable_weighted_bipred=0,
        b_enable_strong_intra_smoothing=0, rc__aq_mode=AQ_NONE, rc__aq_strength=0.0,
        rc__qg_size=32, b_enable_fast_intra=1, b_enable_early_skip=1,
        recursion_skip_mode=1, b_enable_sign_hiding=0, b_enable_temporal_mvp=0,
        max_num_merge_cand=2, limit_references=0, rc__rf_constant_max=0.0,
    ),
    "superfast": dict(
        max_cu_size=32, bframes=3, b_frame_adaptive=B_ADAPT_NONE, rc__cu_tree=0,
        lookahead_depth=10, search_method=ME_HEX, subpel_refine=1,
        max_num_references=1, rd_level=2, b_enable_weighted_pred=0,
        b_enable_strong_intra_smoothing=0, max_num_merge_cand=2, limit_references=0,
        rc__aq_mode=AQ_NONE, rc__aq_strength=0.0, b_enable_early_skip=1,
        b_enable_sao=0, b_enable_fast_intra=1,
    ),
    "veryfast": dict(
        bframes=4, lookahead_depth=15, subpel_refine=1, max_num_references=2,
        rd_level=2, b_enable_early_skip=1, b_enable_fast_intra=1,
        max_num_merge_cand=2, limit_references=3,
    ),
    "faster": dict(
        bframes=4, lookahead_depth=15, max_num_references=2, rd_level=2,
        b_enable_fast_intra=1, b_enable_early_skip=1, max_num_merge_cand=2,
        limit_references=3,
    ),
    "fast": dict(
        bframes=4, lookahead_depth=15, max_num_references=2, rd_level=2,
        b_enable_early_skip=0, b_enable_fast_intra=1, max_num_merge_cand=2,
        limit_references=3,
    ),
    "medium": dict(),  # the defaults
    "slow": dict(
        b_enable_rect_inter=1, b_frame_adaptive=B_ADAPT_TRELLIS, lookahead_depth=25,
        subpel_refine=3, max_num_references=4, search_method=ME_STAR, rd_level=4,
        b_enable_early_skip=0, recursion_skip_mode=1, max_num_merge_cand=3,
        b_intra_in_bframes=1, limit_references=3, limit_modes=1, rdoq_level=2,
        psy_rdoq=1.0,
    ),
    "slower": dict(
        b_enable_weighted_bipred=1, b_enable_amp=1, b_enable_rect_inter=1,
        bframes=8, b_frame_adaptive=B_ADAPT_TRELLIS, lookahead_depth=40,
        subpel_refine=4, max_num_references=5, search_method=ME_STAR, rd_level=6,
        b_enable_early_skip=0, recursion_skip_mode=0, max_num_merge_cand=4,
        b_intra_in_bframes=1, tu_qt_max_inter_depth=3, tu_qt_max_intra_depth=3,
        limit_references=1, limit_modes=1, limit_tu=4, rdoq_level=2, psy_rdoq=1.0,
        b_enable_rd_refine=1,
    ),
    "veryslow": dict(
        b_enable_weighted_bipred=1, b_enable_amp=1, b_enable_rect_inter=1,
        bframes=8, b_frame_adaptive=B_ADAPT_TRELLIS, lookahead_depth=40,
        subpel_refine=4, max_num_references=5, search_method=ME_STAR, rd_level=6,
        b_enable_early_skip=0, recursion_skip_mode=0, max_num_merge_cand=5,
        b_intra_in_bframes=1, tu_qt_max_inter_depth=3, tu_qt_max_intra_depth=3,
        limit_references=0, limit_modes=0, limit_tu=0, rdoq_level=2, psy_rdoq=1.0,
        b_enable_rd_refine=1, b_enable_tskip_fast=0,
    ),
    "placebo": dict(
        b_enable_weighted_bipred=1, b_enable_amp=1, b_enable_rect_inter=1,
        bframes=8, b_frame_adaptive=B_ADAPT_TRELLIS, lookahead_depth=60,
        search_method=ME_STAR, subpel_refine=5, max_num_references=5, rd_level=6,
        b_enable_early_skip=0, recursion_skip_mode=0, max_num_merge_cand=5,
        b_intra_in_bframes=1, tu_qt_max_inter_depth=4, tu_qt_max_intra_depth=4,
        limit_references=0, limit_modes=0, limit_tu=0, rdoq_level=2, psy_rdoq=1.0,
        b_enable_rd_refine=1, b_enable_transform_skip=1,
    ),
}


def _apply_overrides(p: Param, overrides: Dict[str, object]) -> None:
    for key, value in overrides.items():
        if key.startswith("rc__"):
            setattr(p.rc, key[4:], value)
        else:
            setattr(p, key, value)


def param_default() -> Param:
    return Param()


def param_default_preset(preset: Optional[str] = None,
                         tune: Optional[str] = None) -> Param:
    """x265_param_default_preset analog (param.cpp:382)."""
    p = Param()
    if preset:
        preset = preset.strip().lower()
        if preset.isdigit():
            idx = int(preset)
            if not 0 <= idx < len(PRESET_NAMES):
                raise ParamError(f"invalid preset index {idx}")
            preset = PRESET_NAMES[idx]
        if preset not in _PRESETS:
            raise ParamError(f"unknown preset '{preset}'")
        _apply_overrides(p, _PRESETS[preset])
    if tune:
        tune = tune.strip().lower()
        if tune not in TUNE_NAMES:
            raise ParamError(f"unknown tune '{tune}'")
        if tune == "psnr":
            p.rc.aq_mode = AQ_NONE
            p.rc.aq_strength = 0.0
            p.psy_rd = 0.0
            p.psy_rdoq = 0.0
        elif tune == "ssim":
            p.rc.aq_mode = AQ_AUTO_VARIANCE
            p.psy_rd = 0.0
            p.psy_rdoq = 0.0
        elif tune == "grain":
            p.rc.ip_factor = 1.1
            p.rc.pb_factor = 1.0
            p.rc.cu_tree = 0
            p.rc.aq_mode = AQ_NONE
            p.rc.qp_step = 1
            p.rc.b_enable_grain = 1
            p.recursion_skip_mode = 1
            p.psy_rd = 4.0
            p.psy_rdoq = 10.0
        elif tune == "fastdecode":
            p.b_enable_loop_filter = 0
            p.b_enable_sao = 0
            p.b_enable_weighted_pred = 0
            p.b_enable_weighted_bipred = 0
            p.b_intra_in_bframes = 0
        elif tune == "zerolatency":
            p.b_frame_adaptive = B_ADAPT_NONE
            p.bframes = 0
            p.lookahead_depth = 0
            p.scenecut_threshold = 0
            p.rc.cu_tree = 0
            p.frame_num_threads = 1
        elif tune == "animation":
            p.bframes = min(p.bframes + 2, 16)
            p.psy_rd = 0.4
            p.rc.aq_strength = 0.4
            p.deblocking_filter_beta_offset = 1
            p.deblocking_filter_tc_offset = 1
    return p


# ---------------------------------------------------------------------------
# Name→value string parser (x265_param_parse, param.cpp:785)
# ---------------------------------------------------------------------------

def _atobool(v): return _bool(v)
def _atoi(v): return int(str(v).strip(), 0)
def _atof(v): return float(v)


def _parse_csp(v):
    v = str(v).strip().lower()
    if v in CSP_NAMES:
        return CSP_NAMES[v]
    return _atoi(v)


def _parse_me(v):
    v = str(v).strip().lower()
    if v in ME_NAMES:
        return ME_NAMES.index(v)
    return _atoi(v)


def _parse_hash(v):
    names = {"none": 0, "md5": 1, "crc": 2, "crc32": 2, "checksum": 3}
    v = str(v).strip().lower()
    return names.get(v, None) if not v.isdigit() else _atoi(v)


def _parse_fps(p: Param, v: str):
    v = str(v).strip()
    if "/" in v:
        num, den = v.split("/")
        p.fps_num, p.fps_denom = _atoi(num), _atoi(den)
    else:
        f = float(v)
        if f == int(f):
            p.fps_num, p.fps_denom = int(f), 1
        else:
            p.fps_num, p.fps_denom = int(round(f * 1000)), 1000


def _parse_res(p: Param, v: str):
    w, h = str(v).lower().split("x")
    p.source_width, p.source_height = _atoi(w), _atoi(h)


# Each entry: option-name → setter(param, value-string).
# Covers the x265_param_parse names (Appendix A.1 of SURVEY.md).
def _build_option_table():
    T: Dict[str, object] = {}

    def opt(name, fn):
        T[name] = fn

    def setp(attr, conv):
        def fn(p, v):
            setattr(p, attr, conv(v))
        return fn

    def setrc(attr, conv):
        def fn(p, v):
            setattr(p.rc, attr, conv(v))
        return fn

    def setvui(attr, conv):
        def fn(p, v):
            setattr(p.vui, attr, conv(v))
        return fn

    def ignored(p, v):   # accepted for CLI parity; no meaning here
        return None

    # parallelism / threading (kept for parity)
    opt("wpp", setp("b_enable_wavefront", _atobool))
    opt("frame-threads", setp("frame_num_threads", _atoi))
    opt("pools", setp("num_pools", str))
    opt("numa-pools", setp("num_pools", str))
    opt("pmode", setp("b_distribute_mode_analysis", _atobool))
    opt("pme", setp("b_distribute_motion_estimation", _atobool))
    opt("lookahead-slices", setp("lookahead_slices", _atoi))
    opt("lookahead-threads", setp("lookahead_threads", _atoi))
    opt("slices", setp("max_slices", _atoi))
    opt("asm", ignored)
    opt("cpuid", ignored)

    # logging / stats
    opt("log-level", setp("log_level", _atoi))
    opt("csv", setp("csv_fn", str))
    opt("csv-log-level", setp("csv_log_level", _atoi))
    opt("psnr", setp("b_enable_psnr", _atobool))
    opt("ssim", setp("b_enable_ssim", _atobool))

    # input / internals
    opt("input-res", _parse_res)
    opt("fps", _parse_fps)
    opt("input-csp", setp("internal_csp", _parse_csp))
    opt("input-depth", setp("source_bit_depth", _atoi))
    opt("output-depth", setp("internal_bit_depth", _atoi))
    opt("internal-bitdepth", setp("internal_bit_depth", _atoi))
    opt("frames", setp("total_frames", _atoi))
    opt("total-frames", setp("total_frames", _atoi))
    opt("interlace", setp("interlace_mode", lambda v: {"prog": 0, "tff": 1, "bff": 2}.get(str(v).lower(), _atoi(v))))

    # profile/level
    opt("level-idc", setp("level_idc", lambda v: int(float(v) * 10) if "." in str(v) else (_atoi(v) * 10 if _atoi(v) < 100 else _atoi(v))))
    opt("high-tier", setp("b_high_tier", _atobool))
    opt("uhd-bd", setp("uhd_bluray", _atobool))
    opt("allow-non-conformance", setp("b_allow_non_conformance", _atobool))

    # bitstream
    opt("annexb", setp("b_annexb", _atobool))
    opt("repeat-headers", setp("b_repeat_headers", _atobool))
    opt("aud", setp("b_enable_access_unit_delimiters", _atobool))
    opt("hrd", setp("b_emit_hrd_sei", _atobool))
    opt("info", setp("b_emit_info_sei", _atobool))
    opt("hash", setp("decoded_picture_hash_sei", _parse_hash))
    opt("temporal-layers", setp("b_enable_temporal_sub_layers", _atobool))
    opt("log2-max-poc-lsb", setp("log2_max_poc_lsb", _atoi))
    opt("vui-timing-info", setp("b_emit_vui_timing_info", _atobool))
    opt("vui-hrd-info", setp("b_emit_vui_hrd_info", _atobool))
    opt("opt-qp-pps", setp("b_opt_qp_pps", _atobool))
    opt("opt-ref-list-length-pps", setp("b_opt_ref_list_length_pps", _atobool))
    opt("opt-cu-delta-qp", setp("b_opt_cu_delta_qp", _atobool))
    opt("idr-recovery-sei", setp("b_emit_idr_recovery_sei", _atobool))

    # GOP / lookahead
    opt("open-gop", setp("b_open_gop", _atobool))
    opt("keyint", setp("keyframe_max", _atoi))
    opt("min-keyint", setp("keyframe_min", _atoi))
    opt("gop-lookahead", setp("gop_lookahead", _atoi))
    opt("bframes", setp("bframes", _atoi))
    opt("rc-lookahead", setp("lookahead_depth", _atoi))
    opt("b-adapt", setp("b_frame_adaptive", _atoi))
    opt("b-pyramid", setp("b_bpyramid", _atobool))
    opt("bframe-bias", setp("b_frame_bias", _atoi))
    opt("scenecut", setp("scenecut_threshold", lambda v: 0 if str(v).lower() in ("0", "false", "no", "off") else _atoi(v)))
    opt("hist-scenecut", setp("b_hist_based_scenecut", _atobool))
    opt("hist-threshold", setp("edge_transition_threshold", _atof))
    opt("scenecut-bias", setp("scenecut_bias", _atof))
    opt("radl", setp("radl", _atoi))
    opt("fades", setp("b_enable_fades", _atobool))
    opt("scenecut-aware-qp", setp("b_enable_scenecut_aware_qp", _atoi))
    opt("intra-refresh", setp("b_intra_refresh", _atobool))

    # CU / TU
    opt("ctu", setp("max_cu_size", _atoi))
    opt("min-cu-size", setp("min_cu_size", _atoi))
    opt("rect", setp("b_enable_rect_inter", _atobool))
    opt("amp", setp("b_enable_amp", _atobool))
    opt("limit-modes", setp("limit_modes", _atobool))
    opt("limit-refs", setp("limit_references", _atoi))
    opt("max-tu-size", setp("max_tu_size", _atoi))
    opt("tu-inter-depth", setp("tu_qt_max_inter_depth", _atoi))
    opt("tu-intra-depth", setp("tu_qt_max_intra_depth", _atoi))
    opt("limit-tu", setp("limit_tu", _atoi))
    opt("rdoq-level", setp("rdoq_level", _atoi))
    opt("signhide", setp("b_enable_sign_hiding", _atobool))
    opt("tskip", setp("b_enable_transform_skip", _atobool))
    opt("tskip-fast", setp("b_enable_tskip_fast", _atobool))
    opt("nr-intra", setp("noise_reduction_intra", _atoi))
    opt("nr-inter", setp("noise_reduction_inter", _atoi))

    # intra
    opt("constrained-intra", setp("b_enable_constrained_intra", _atobool))
    opt("cip", setp("b_enable_constrained_intra", _atobool))
    opt("strong-intra-smoothing", setp("b_enable_strong_intra_smoothing", _atobool))
    opt("fast-intra", setp("b_enable_fast_intra", _atobool))
    opt("b-intra", setp("b_intra_in_bframes", _atobool))

    # inter
    opt("me", setp("search_method", _parse_me))
    opt("subme", setp("subpel_refine", _atoi))
    opt("merange", setp("search_range", _atoi))
    opt("max-merge", setp("max_num_merge_cand", _atoi))
    opt("weightp", setp("b_enable_weighted_pred", _atobool))
    opt("w", setp("b_enable_weighted_pred", _atobool))
    opt("weightb", setp("b_enable_weighted_bipred", _atobool))
    opt("early-skip", setp("b_enable_early_skip", _atobool))
    opt("rskip", setp("recursion_skip_mode", _atoi))
    opt("rskip-edge-threshold", setp("edge_var_threshold", _atof))
    opt("ref", setp("max_num_references", _atoi))
    opt("tmvp", setp("b_enable_temporal_mvp", _atobool))
    opt("hme", setp("b_enable_hme", _atobool))
    opt("hme-search", lambda p, v: setattr(p, "hme_search_method", tuple(_parse_me(x) for x in str(v).split(","))))
    opt("hme-range", lambda p, v: setattr(p, "hme_range", tuple(_atoi(x) for x in str(v).split(","))))
    opt("analyze-src-pics", setp("b_source_reference_estimation", _atobool))
    opt("dynamic-rd", setp("dynamic_rd", _atof))
    opt("splitrd-skip", setp("b_enable_split_rd_skip", _atobool))

    # analysis / RDO
    opt("rd", setp("rd_level", _atoi))
    opt("psy-rd", setp("psy_rd", _atof))
    opt("psy-rdoq", setp("psy_rdoq", _atof))
    opt("rd-penalty", setp("rd_penalty", _atoi))
    opt("rd-refine", setp("b_enable_rd_refine", _atobool))
    opt("lossless", setp("b_lossless", _atobool))
    opt("cu-lossless", setp("b_cu_lossless", _atobool))
    opt("analysis-save", setp("analysis_save", str))
    opt("analysis-load", setp("analysis_load", str))
    opt("analysis-save-reuse-level", setp("analysis_save_reuse_level", _atoi))
    opt("analysis-load-reuse-level", setp("analysis_load_reuse_level", _atoi))
    opt("scale-factor", setp("scale_factor", _atoi))
    opt("refine-intra", setp("intra_refine", _atoi))
    opt("refine-inter", setp("inter_refine", _atoi))
    opt("refine-mv", setp("mv_refine", _atoi))
    opt("dynamic-refine", setp("b_dynamic_refine", _atobool))
    opt("ssim-rd", setp("b_ssim_rd", _atobool))

    # loop filter / SAO
    opt("deblock", lambda p, v: _parse_deblock(p, v))
    opt("sao", setp("b_enable_sao", _atobool))
    opt("sao-non-deblock", setp("b_sao_non_deblocked", _atobool))
    opt("limit-sao", setp("b_limit_sao", _atobool))
    opt("selective-sao", setp("selective_sao", _atoi))

    # QP offsets
    opt("cbqpoffs", setp("cb_qp_offset", _atoi))
    opt("crqpoffs", setp("cr_qp_offset", _atoi))

    # rate control
    opt("bitrate", setrc("bitrate", _atoi))
    opt("qp", lambda p, v: (_set_cqp(p, _atoi(v))))
    opt("crf", lambda p, v: (_set_crf(p, _atof(v))))
    opt("crf-max", setrc("rf_constant_max", _atof))
    opt("crf-min", setrc("rf_constant_min", _atof))
    opt("vbv-maxrate", setrc("vbv_max_bitrate", _atoi))
    opt("vbv-bufsize", setrc("vbv_buffer_size", _atoi))
    opt("vbv-init", setrc("vbv_buffer_init", _atof))
    opt("vbv-end", setp("vbv_buffer_end", _atof))
    opt("vbv-end-fr-adj", setp("vbv_end_frame_adjust", _atof))
    opt("min-vbv-fullness", setp("min_vbv_fullness", _atof))
    opt("max-vbv-fullness", setp("max_vbv_fullness", _atof))
    opt("qcomp", setrc("q_compress", _atof))
    opt("qpstep", setrc("qp_step", _atoi))
    opt("qpmin", setrc("qp_min", _atoi))
    opt("qpmax", setrc("qp_max", _atoi))
    opt("ipratio", setrc("ip_factor", _atof))
    opt("pbratio", setrc("pb_factor", _atof))
    opt("aq-mode", setrc("aq_mode", _atoi))
    opt("aq-strength", setrc("aq_strength", _atof))
    opt("hevc-aq", setrc("hevc_aq", _atobool))
    opt("qp-adaptation-range", setrc("qp_adaptation_range", _atof))
    opt("aq-motion", ignored)
    opt("cutree", setrc("cu_tree", _atobool))
    opt("no-cutree", lambda p, v: setattr(p.rc, "cu_tree", 0))
    opt("qg-size", setrc("qg_size", _atoi))
    opt("strict-cbr", setrc("b_strict_cbr", _atobool))
    opt("const-vbv", setrc("b_enable_const_vbv", _atobool))
    opt("rc-grain", setrc("b_enable_grain", _atobool))
    opt("pass", lambda p, v: _set_pass(p, _atoi(v)))
    opt("stats", setrc("stat_file_name", str))
    opt("slow-firstpass", setrc("b_enable_slow_first_pass", _atobool))
    opt("multi-pass-opt-rps", ignored)
    opt("qblur", setrc("qblur", _atof))
    opt("cplxblur", setrc("complexity_blur", _atof))
    opt("zonefile", lambda p, v: _parse_zonefile(p, v))
    opt("zones", lambda p, v: _parse_zones(p, v))

    # VUI
    opt("sar", lambda p, v: _parse_sar(p, v))
    opt("overscan", lambda p, v: _parse_overscan(p, v))
    opt("videoformat", setvui("video_format", lambda v: {"component": 0, "pal": 1, "ntsc": 2, "secam": 3, "mac": 4, "unknown": 5, "undef": 5}.get(str(v).lower(), _atoi(v))))
    opt("range", lambda p, v: setattr(p.vui, "b_enable_video_full_range_flag", {"limited": 0, "full": 1}.get(str(v).lower(), _atobool(v))))
    opt("colorprim", setvui("color_primaries", lambda v: _COLORPRIM.get(str(v).lower(), None) if not str(v).isdigit() else _atoi(v)))
    opt("transfer", setvui("transfer_characteristics", lambda v: _TRANSFER.get(str(v).lower(), None) if not str(v).isdigit() else _atoi(v)))
    opt("colormatrix", setvui("matrix_coeffs", lambda v: _MATRIX.get(str(v).lower(), None) if not str(v).isdigit() else _atoi(v)))
    opt("chromaloc", lambda p, v: (_set_chromaloc(p, _atoi(v))))

    # HDR
    opt("master-display", setp("master_display", str))
    opt("max-cll", lambda p, v: _parse_cll(p, v))
    opt("hdr10", setp("b_emit_hdr10_sei", _atobool))
    opt("hdr", setp("b_emit_hdr10_sei", _atobool))
    opt("hdr10-opt", setp("b_hdr10_opt", _atobool))
    opt("min-luma", setp("min_luma", _atoi))
    opt("max-luma", setp("max_luma", _atoi))
    opt("chunk-start", setp("chunk_start", _atoi))
    opt("chunk-end", setp("chunk_end", _atoi))
    opt("frame-dup", setp("b_enable_frame_duplication", _atobool))
    opt("dup-threshold", setp("dup_threshold", _atoi))
    opt("mcstf", setp("b_enable_temporal_filter", _atobool))
    opt("field", ignored)

    return T


_COLORPRIM = {"bt709": 1, "undef": 2, "bt470m": 4, "bt470bg": 5, "smpte170m": 6,
              "smpte240m": 7, "film": 8, "bt2020": 9, "smpte428": 10,
              "smpte431": 11, "smpte432": 12}
_TRANSFER = {"bt709": 1, "undef": 2, "bt470m": 4, "bt470bg": 5, "smpte170m": 6,
             "smpte240m": 7, "linear": 8, "log100": 9, "log316": 10,
             "iec61966-2-4": 11, "bt1361e": 12, "iec61966-2-1": 13,
             "bt2020-10": 14, "bt2020-12": 15, "smpte2084": 16, "smpte428": 17,
             "arib-std-b67": 18}
_MATRIX = {"gbr": 0, "bt709": 1, "undef": 2, "fcc": 4, "bt470bg": 5,
           "smpte170m": 6, "smpte240m": 7, "ycgco": 8, "bt2020nc": 9,
           "bt2020c": 10, "smpte2085": 11, "chroma-derived-nc": 12,
           "chroma-derived-c": 13, "ictcp": 14}


def _set_cqp(p: Param, qp: int):
    p.rc.qp = qp
    p.rc.rate_control_mode = RC_CQP
    p.rc.aq_mode = AQ_NONE
    p.rc.cu_tree = 0


def _set_crf(p: Param, crf: float):
    p.rc.rf_constant = crf
    p.rc.rate_control_mode = RC_CRF


def _parse_zones(p: Param, spec: str):
    """--zones start,end,q=N|b=F[/...] (param.cpp:1078): later zones take
    precedence (session applies first-match, so store reversed)."""
    zones = []
    for part in str(spec).split("/"):
        s_, e_, opt_ = part.split(",", 2)
        k, _, val = opt_.partition("=")
        z = Zone(start_frame=int(s_), end_frame=int(e_))
        if k == "q":
            z.b_force_qp = 1
            z.qp = int(val)
        elif k == "b":
            z.b_force_qp = 0
            z.bitrate_factor = float(val)
        else:
            raise ParamError(f"bad zone option '{opt_}'")
        zones.append(z)
    p.rc.zones = list(reversed(zones))        # later-in-list wins
    p.rc.zone_count = len(zones)


def _parse_zonefile(p: Param, path: str):
    """--zonefile: each line '<frame> <cli options...>'; the options form a
    param CLONE applied from that frame until the next zone starts (the
    reference's zones-as-param-clones, x265cli.cpp:960 parseZoneFile +
    encoder.cpp:2467 reconfig whitelist)."""
    starts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            starts.append((int(tok[0]), tok[1:]))
    starts.sort(key=lambda t: t[0])
    zones = []
    for i, (sf, opts) in enumerate(starts):
        zp = p.copy()
        zp.rc.zones = []
        zp.rc.zone_count = zp.rc.zonefile_count = 0
        j = 0
        while j < len(opts):
            name = opts[j].lstrip("-")
            val = None
            if "=" in name:
                name, val = name.split("=", 1)
            elif j + 1 < len(opts) and not opts[j + 1].startswith("--"):
                j += 1
                val = opts[j]
            param_parse(zp, name, val)
            j += 1
        end = (starts[i + 1][0] - 1) if i + 1 < len(starts) else (1 << 30)
        zones.append(Zone(start_frame=sf, end_frame=end, zone_param=zp))
    p.rc.zones = zones
    p.rc.zonefile_count = len(zones)
    p.rc.zone_count = 0


def _set_pass(p: Param, n: int):
    if n == 1:
        p.rc.b_stat_write, p.rc.b_stat_read = 1, 0
    elif n == 2:
        p.rc.b_stat_write, p.rc.b_stat_read = 0, 1
    elif n == 3:
        p.rc.b_stat_write, p.rc.b_stat_read = 1, 1
    else:
        raise ParamError(f"invalid pass {n}")


def _set_chromaloc(p: Param, v: int):
    p.vui.b_enable_chroma_loc_info_present_flag = 1
    p.vui.chroma_sample_loc_type_top_field = v
    p.vui.chroma_sample_loc_type_bottom_field = v


def _parse_deblock(p: Param, v):
    s = str(v).strip().lower()
    if s in ("1", "true", "yes", "on", ""):
        p.b_enable_loop_filter = 1
    elif s in ("0", "false", "no", "off"):
        p.b_enable_loop_filter = 0
    else:
        parts = s.split(":") if ":" in s else s.split(",")
        p.b_enable_loop_filter = 1
        p.deblocking_filter_tc_offset = int(parts[0])
        p.deblocking_filter_beta_offset = int(parts[1]) if len(parts) > 1 else int(parts[0])


def _parse_sar(p: Param, v):
    s = str(v).strip()
    named = {"1:1": 1, "12:11": 2, "10:11": 3, "16:11": 4, "40:33": 5, "24:11": 6,
             "20:11": 7, "32:11": 8, "80:33": 9, "18:11": 10, "15:11": 11,
             "64:33": 12, "160:99": 13, "4:3": 14, "3:2": 15, "2:1": 16}
    if s in named:
        p.vui.aspect_ratio_idc = named[s]
    elif ":" in s or "/" in s:
        sep = ":" if ":" in s else "/"
        w, h = s.split(sep)
        p.vui.aspect_ratio_idc = 255
        p.vui.sar_width, p.vui.sar_height = int(w), int(h)
    else:
        p.vui.aspect_ratio_idc = int(s)


def _parse_overscan(p: Param, v):
    s = str(v).strip().lower()
    if s == "show":
        p.vui.b_enable_overscan_info_present_flag = 1
        p.vui.b_enable_overscan_appropriate_flag = 0
    elif s == "crop":
        p.vui.b_enable_overscan_info_present_flag = 1
        p.vui.b_enable_overscan_appropriate_flag = 1
    elif s in ("undef", "unknown"):
        p.vui.b_enable_overscan_info_present_flag = 0


def _parse_cll(p: Param, v):
    parts = str(v).split(",")
    p.max_cll = int(parts[0])
    if len(parts) > 1:
        p.max_fall = int(parts[1])
    p.b_emit_cll_sei = 1


_OPTION_TABLE = _build_option_table()


def param_parse(p: Param, name: str, value=None) -> None:
    """x265_param_parse analog. Supports "no-" prefixes and _/- equivalence."""
    name = name.strip().lower().replace("_", "-")
    negate = False
    if name.startswith("no-"):
        negate = True
        name = name[3:]
    if name not in _OPTION_TABLE:
        raise ParamError(f"unknown option '{name}'")
    if negate:
        value = "false" if value in (None, "", "1", "true") else ("false" if _bool(value) else "true")
    elif value is None:
        value = "true"
    _OPTION_TABLE[name](p, value)


def known_options() -> List[str]:
    return sorted(_OPTION_TABLE.keys())


# ---------------------------------------------------------------------------
# Validation (x265_check_params, param.cpp:1592)
# ---------------------------------------------------------------------------

def check_params(p: Param) -> List[str]:
    """Return a list of validation errors (empty = OK). Mutates p to apply
    the same auto-fixups the reference applies in Encoder::configure."""
    errors = []

    def check(cond, msg):
        if not cond:
            errors.append(msg)

    check(p.source_width > 0 and p.source_height > 0, "picture dimensions must be >0")
    check(p.source_width % 2 == 0 or p.internal_csp in (CSP_I400, CSP_I444),
          "width must be even for subsampled chroma")
    check(p.internal_bit_depth in (8, 10, 12), "internal bit depth must be 8/10/12")
    check(p.internal_csp in (CSP_I400, CSP_I420, CSP_I422, CSP_I444), "invalid csp")
    check(p.max_cu_size in (16, 32, 64), "ctu must be 16/32/64")
    check(p.min_cu_size in (8, 16, 32, 64), "min-cu-size must be 8/16/32/64")
    check(p.min_cu_size <= p.max_cu_size, "min-cu-size must be <= ctu")
    check(p.max_tu_size in (4, 8, 16, 32), "max-tu-size must be 4/8/16/32")
    check(0 <= p.bframes <= 16, "bframes must be 0..16")
    check(p.lookahead_depth <= 250, "rc-lookahead max is 250")
    check(0 <= p.subpel_refine <= 7, "subme must be 0..7")
    check(1 <= p.max_num_references <= 16, "ref must be 1..16")
    check(1 <= p.max_num_merge_cand <= 5, "max-merge must be 1..5")
    check(1 <= p.rd_level <= 6, "rd must be 1..6")
    check(0 <= p.rdoq_level <= 2, "rdoq-level must be 0..2")
    check(0 <= p.rc.aq_mode <= 4, "aq-mode must be 0..4")
    check(0.0 <= p.rc.aq_strength <= 3.0, "aq-strength must be 0..3")
    check(0 <= p.rc.qp <= p.qp_max_allowed, f"qp must be 0..{p.qp_max_allowed}")
    check(p.rc.rf_constant <= QP_MAX_SPEC, "crf must be <= 51")
    check(p.search_range >= 0, "merange must be >= 0")
    check(0 <= p.search_method <= 5, "invalid me method")
    check(p.keyframe_max >= -1, "keyint must be >= -1")
    check(p.rc.qg_size in (8, 16, 32, 64), "qg-size must be 8/16/32/64")
    check(abs(p.cb_qp_offset) <= 12 and abs(p.cr_qp_offset) <= 12,
          "chroma qp offsets must be in [-12,12]")
    check(abs(p.deblocking_filter_tc_offset) <= 6 and
          abs(p.deblocking_filter_beta_offset) <= 6,
          "deblock offsets must be in [-6,6]")

    # auto fixups mirroring Encoder::configure
    if p.keyframe_max <= 0:
        p.keyframe_max = 1 if p.keyframe_max == 0 else (1 << 30)
    if p.keyframe_min <= 0:
        p.keyframe_min = min(max(p.keyframe_max // 10, 1), p.keyframe_max)
    p.keyframe_min = min(p.keyframe_min, p.keyframe_max)
    if p.b_lossless:
        p.rc.rate_control_mode = RC_CQP
        p.rc.qp = 4
        p.rc.aq_mode = AQ_NONE
        p.b_enable_sign_hiding = 0
        p.rdoq_level = 0
    if p.internal_csp == CSP_I400:
        p.cb_qp_offset = p.cr_qp_offset = 0
    if p.total_frames == 1:
        p.bframes = 0
        p.lookahead_depth = 0
    p.rc.qp_min = max(p.rc.qp_min, 0)
    p.rc.qp_max = min(p.rc.qp_max, QP_MAX_MAX)
    return errors


# ---------------------------------------------------------------------------
# param→string (x265_param2string analog, used by the info SEI & CSV log)
# ---------------------------------------------------------------------------

def param_to_string(p: Param) -> str:
    on = lambda b, name: f"{name}" if b else f"no-{name}"
    parts = [
        # the reference package's string, byte for byte
        f"cpuid=tpu", f"frame-threads={p.frame_num_threads}",
        on(p.b_enable_wavefront, "wpp"),
        f"ctu={p.max_cu_size}", f"min-cu-size={p.min_cu_size}",
        f"max-tu-size={p.max_tu_size}",
        f"tu-intra-depth={p.tu_qt_max_intra_depth}",
        f"tu-inter-depth={p.tu_qt_max_inter_depth}",
        f"me={p.search_method}", f"subme={p.subpel_refine}",
        f"merange={p.search_range}", f"rect={p.b_enable_rect_inter}",
        f"amp={p.b_enable_amp}", f"max-merge={p.max_num_merge_cand}",
        f"bframes={p.bframes}", f"b-adapt={p.b_frame_adaptive}",
        f"keyint={p.keyframe_max}", f"min-keyint={p.keyframe_min}",
        f"rc-lookahead={p.lookahead_depth}", f"ref={p.max_num_references}",
        f"rd={p.rd_level}", f"psy-rd={p.psy_rd:.2f}",
        f"rdoq-level={p.rdoq_level}", f"psy-rdoq={p.psy_rdoq:.2f}",
        on(p.b_enable_sign_hiding, "signhide"),
        on(p.b_enable_loop_filter, "deblock"),
        on(p.b_enable_sao, "sao"),
        f"aq-mode={p.rc.aq_mode}", f"aq-strength={p.rc.aq_strength:.2f}",
        f"cutree={p.rc.cu_tree}", f"qg-size={p.rc.qg_size}",
    ]
    rcm = p.rc.rate_control_mode
    if rcm == RC_CQP:
        parts.append(f"qp={p.rc.qp}")
    elif rcm == RC_CRF:
        parts.append(f"crf={p.rc.rf_constant:.1f}")
    else:
        parts.append(f"bitrate={p.rc.bitrate}")
    parts.append(f"ipratio={p.rc.ip_factor:.2f}")
    parts.append(f"pbratio={p.rc.pb_factor:.2f}")
    return " ".join(parts)
