"""Public API: the x265 C-API surface (x265.h, encoder/api.cpp) as the
port's library entry points.

Port of x265_yuuki_asuna_tpu/api.py: the x265_param_* / x265_picture_* /
x265_encoder_* functions with Python naming. Encoder derives the session
from the Param the way Encoder::configure does (the all-intra session for
keyint <= 1 under CQP without B frames, else the video session, with the
CTU32 quadtree of depth 2 when the minimum CU is 8, of depth 1 when it is
16 as at "ultrafast", the uniform grid when the minimum CU is the CTU of
16 or 32; the all-intra uniform grid codes x265's default wavefront as
WPP substreams, and b_lossless there), on the CUDA card unless the
caller passes device="cpu". The uniform P-only session takes the
reference's two L0 references and TMVP (one reference with TMVP under
weightp). The rest of the x265.h surface: cleanup, dither_image,
calculate_vmaf (libvmaf is not built in: RuntimeError, as the
reference's build without it), get_slicetype_poc_and_scenecut,
get_ref_frame_list and set_analysis_data (records in the
--analysis-save format; they steer the motion search of a session made
with analysis_load or analysis_share, as in the reference).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .bitstream.sei import pick_level
from .models.encoder_top import IntraEncoderSession, VideoEncoderSession
from .utils import param as P
from .utils.param import Param, ParamError, RC_ABR, RC_CQP, RC_CRF

# -- param lifecycle (x265_param_alloc/default/parse/...) -------------------

param_default = P.param_default
param_default_preset = P.param_default_preset
param_parse = P.param_parse


def param_alloc() -> Param:
    return P.param_default()


def param_apply_profile(p: Param, profile: Optional[str]):
    """x265_param_apply_profile subset: main / main10 / mainstillpicture."""
    if not profile:
        return
    profile = profile.strip().lower()
    if profile == "main":
        p.internal_bit_depth = 8
    elif profile == "main10":
        p.internal_bit_depth = 10
    elif profile in ("mainstillpicture", "msp", "main-intra"):
        p.keyframe_max = 1
        p.bframes = 0
    else:
        raise ParamError(f"unknown profile '{profile}'")


# -- picture (x265_picture) --------------------------------------------------

@dataclass
class Picture:
    planes: Tuple[np.ndarray, np.ndarray, np.ndarray] = None
    pts: int = 0
    poc: int = 0
    slice_type: str = ""
    bit_depth: int = 8


def picture_alloc() -> Picture:
    return Picture()


def picture_init(p: Param, pic: Picture):
    pic.bit_depth = p.internal_bit_depth
    return pic


# -- stats (x265_stats / x265_frame_stats subset) ----------------------------

@dataclass
class Stats:
    encoded_picture_count: int = 0
    accumulated_bits: int = 0
    global_psnr_y: float = 0.0
    elapsed_seconds: float = 0.0

    @property
    def bitrate_kbps_at(self):
        def f(fps: float) -> float:
            n = max(self.encoded_picture_count, 1)
            return self.accumulated_bits * fps / n / 1000.0
        return f


_RC_MODES = {RC_CQP: "cqp", RC_CRF: "crf", RC_ABR: "abr"}


# -- encoder session ----------------------------------------------------------

class Encoder:
    """x265_encoder analog: owns one encode session configured from Param,
    on `device` (None: the CUDA card; "cpu": every kernel's plain
    version)."""

    def __init__(self, p: Param, device=None):
        if p.source_width <= 0 or p.source_height <= 0:
            raise ParamError("sourceWidth/sourceHeight required")
        self.param = p
        self._t0 = time.time()
        self._stats = Stats()
        self._psnr_sum = 0.0
        fps = (p.fps_num or 25, p.fps_denom or 1)

        ctu = min(p.max_cu_size, 32)
        min_cu = max(p.min_cu_size, 8)
        qt_depth = (ctu.bit_length() - min_cu.bit_length()) \
            if min_cu < ctu else 0
        bframes = p.bframes
        weightp = bool(p.b_enable_weighted_pred)
        rc_mode = _RC_MODES[p.rc.rate_control_mode]
        all_intra = p.keyframe_max <= 1 and rc_mode == "cqp" and not bframes

        if all_intra:
            self._sess = IntraEncoderSession(
                p.source_width, p.source_height, qp=int(p.rc.qp),
                cu_size=ctu, fps=fps,
                hash_sei=p.decoded_picture_hash_sei != 0,
                lossless=bool(p.b_lossless),
                sao=bool(p.b_enable_sao) and not qt_depth,
                deblock=bool(p.b_enable_loop_filter),
                aq_mode=2 if p.rc.aq_mode else 0,
                aq_strength=p.rc.aq_strength,
                rdoq=p.rdoq_level > 0,
                sbh=bool(p.b_enable_sign_hiding),
                wpp=bool(p.b_enable_wavefront) and not qt_depth,
                max_depth=qt_depth, psy_rd=p.psy_rd, device=device)
            self._video = False
        else:
            self._sess = VideoEncoderSession(
                p.source_width, p.source_height, qp=int(p.rc.qp),
                cu_size=ctu, fps=fps,
                keyint=max(p.keyframe_max, 2),
                search_range=min(p.search_range, 24),
                hash_sei=p.decoded_picture_hash_sei != 0,
                rc_mode=rc_mode, crf=p.rc.rf_constant,
                bitrate_kbps=p.rc.bitrate,
                bframes=bframes,
                deblock=bool(p.b_enable_loop_filter),
                sao=bool(p.b_enable_sao),
                vbv_maxrate_kbps=p.rc.vbv_max_bitrate,
                vbv_bufsize_kbps=p.rc.vbv_buffer_size,
                rdoq=p.rdoq_level > 0,
                weightp=weightp,
                sbh=bool(p.b_enable_sign_hiding),
                aq_mode=2 if p.rc.aq_mode else 0,
                aq_strength=p.rc.aq_strength,
                cutree=bool(p.rc.cu_tree),
                n_refs=(min(p.max_num_references, 2)
                        if not (bframes or qt_depth or weightp) else 1),
                tmvp=bool(getattr(p, "b_enable_temporal_mvp", 0))
                and not bframes and not qt_depth,
                max_depth=qt_depth, psy_rd=p.psy_rd, device=device)
            self._video = True
        self._use_b = getattr(self._sess, "bframes", 0) > 0
        # zones (param.cpp:1078 / encoder.cpp:2467 reconfigZone): q=/b=
        # zones feed the session's per-frame QP override; zonefile zones
        # are param clones applied through the reconfig whitelist when
        # the zone's first frame is pushed
        self._param_zones = []
        if getattr(p.rc, "zones", None):
            sess_zones = []
            for z in p.rc.zones:
                if z.zone_param is not None:
                    self._param_zones.append(
                        (z.start_frame, z.end_frame, z.zone_param))
                elif z.b_force_qp:
                    sess_zones.append((z.start_frame, z.end_frame,
                                       int(z.qp), None))
                else:
                    sess_zones.append((z.start_frame, z.end_frame, None,
                                       float(z.bitrate_factor)))
            if sess_zones and hasattr(self._sess, "zones"):
                self._sess.zones = sess_zones
        self._param_zones.sort(key=lambda t: t[0])
        self._push_count = 0
        self._closed = False
        # fatal-error latch (Encoder::m_aborted analog,
        # encoder.cpp:1592): once an internal error escapes, every
        # further encode call fails fast instead of corrupting state
        self._aborted = False

    # -- x265_encoder_headers --
    def headers(self) -> bytes:
        return self._sess.headers()

    # -- x265_encoder_encode: pic_in=None flushes --
    def encode(self, pic_in: Optional[Picture]) -> List[bytes]:
        assert not self._closed
        if self._aborted:
            raise RuntimeError("encoder aborted by a prior error")
        results = []
        if pic_in is None:
            if self._use_b:
                results = self._sess.flush()
        else:
            for s_, e_, zp in self._param_zones:
                if s_ == self._push_count:
                    self.reconfig_zone(zp)
            self._push_count += 1
            y, u, v = pic_in.planes
            try:
                if self._use_b:
                    results = self._sess.push_frame(y, u, v)
                else:
                    results = [self._sess.encode_frame(y, u, v)]
            except Exception:
                self._aborted = True
                raise
        out = []
        for fr in results:
            self._stats.encoded_picture_count += 1
            self._stats.accumulated_bits += fr.bits
            self._psnr_sum += fr.psnr_y
            self._last_frame_info = {
                "sliceType": fr.frame_type,
                "poc": getattr(fr, "poc", None),
                "bScenecut": 1 if fr.frame_type == "I" else 0,
            }
            out.append(fr.nals)
        return out

    # -- x265_encoder_get_stats --
    def get_stats(self) -> Stats:
        n = max(self._stats.encoded_picture_count, 1)
        self._stats.global_psnr_y = self._psnr_sum / n
        self._stats.elapsed_seconds = time.time() - self._t0
        return self._stats

    # -- x265_encoder_reconfig --
    def reconfig(self, p: Param) -> int:
        """Runtime reconfiguration (reference whitelist at encoder.cpp:2467:
        rate control, scenecut, keyint and other runtime scalars apply
        mid-stream; anything baked into the programs or the signalled
        headers is rejected). Returns 0 on success, -1 when the change
        needs a new session (the reference returns failure the same
        way)."""
        if not self._video:
            return -1
        old = self.param
        # program/header-affecting fields cannot change mid-session
        if (p.source_width != old.source_width
                or p.source_height != old.source_height
                or p.max_cu_size != old.max_cu_size
                or p.min_cu_size != old.min_cu_size
                or p.bframes != old.bframes
                or p.internal_bit_depth != old.internal_bit_depth
                or bool(p.b_enable_sao) != bool(old.b_enable_sao)
                or bool(p.b_enable_loop_filter)
                != bool(old.b_enable_loop_filter)
                or bool(p.rc.aq_mode) and not bool(old.rc.aq_mode)):
            return -1
        sess = self._sess
        # rate control: mode + targets are runtime scalars
        rc_mode = _RC_MODES[p.rc.rate_control_mode]
        sess.rc.cfg.mode = rc_mode
        sess.rc.cfg.qp = int(p.rc.qp)
        sess.qp = int(p.rc.qp)
        sess.rc.cfg.crf = p.rc.rf_constant
        if rc_mode == "crf":
            base_cplx = (old.source_width * old.source_height) / 256.0 * 120.0
            sess.rc.rate_factor = (base_cplx ** (1 - sess.rc.cfg.q_compress)) \
                / (0.85 * 2.0 ** ((p.rc.rf_constant - 12.0) / 6.0))
        # GOP / lookahead scalars
        sess.keyint = max(p.keyframe_max, 1)
        sess.scenecut_enabled = p.scenecut_threshold > 0
        if hasattr(sess, "b_adapt"):
            sess.b_adapt = p.b_frame_adaptive
        # AQ strength (mode stays; turning AQ ON needs PPS cu_qp_delta)
        if old.rc.aq_mode:
            sess.aq_strength = p.rc.aq_strength
            sess.aq_mode = p.rc.aq_mode if p.rc.aq_mode else sess.aq_mode
        self.param = p
        return 0

    # -- x265_encoder_reconfig_zone (encoder.cpp:2467 reconfigZone) --
    def reconfig_zone(self, zone_param: Param) -> int:
        """Apply a zone's param clone at its first frame: the same runtime
        whitelist as reconfig(); header/program-affecting fields in the
        clone are ignored rather than rejected (the reference clamps the
        zone to the open stream's configuration)."""
        zp = zone_param.copy()
        old = self.param
        # zones cannot change stream geometry/headers: clamp those fields
        zp.source_width = old.source_width
        zp.source_height = old.source_height
        zp.max_cu_size = old.max_cu_size
        zp.min_cu_size = old.min_cu_size
        zp.bframes = old.bframes
        zp.internal_bit_depth = old.internal_bit_depth
        zp.b_enable_sao = old.b_enable_sao
        zp.b_enable_loop_filter = old.b_enable_loop_filter
        zp.rc.aq_mode = zp.rc.aq_mode if old.rc.aq_mode else 0
        return self.reconfig(zp)

    # -- x265_encoder_intra_refresh --
    def intra_refresh(self) -> int:
        """x265_encoder_intra_refresh (x265.h:2161): force a recovery point
        at the next frame. Video sessions arm a forced IDR (consumed by the
        next push/encode); on an all-intra session every picture is already
        a recovery point, so success without action is the reference's
        behaviour too."""
        if hasattr(self._sess, "intra_refresh"):
            self._sess.intra_refresh()
        return 0

    # -- x265_encoder_ctu_info (x265.h:2168) --
    def ctu_info(self, qp_offsets) -> int:
        """Per-CTU QP offsets from the caller (ROI maps). Array of
        shape [ctu_rows, ctu_cols] ints; None clears. Applied by the
        session on top of AQ/cuTree for subsequent frames (video sessions;
        the all-intra session returns -1)."""
        sess = self._sess
        if not hasattr(sess, "_frame_qp_map"):
            return -1
        if qp_offsets is None:
            sess.ctu_info_offsets = None
            return 0
        arr = np.asarray(qp_offsets, np.int32)
        if arr.shape != (sess.rows, sess.cols):
            return -1
        sess.ctu_info_offsets = arr
        if not (sess.aq_mode or sess.cutree):
            sess.intra_sess.pps.cu_qp_delta = 1
        return 0

    # -- x265_encoder_close --
    def close(self):
        self._closed = True


def encoder_open(p: Param, device=None) -> Encoder:
    check_params(p)
    return Encoder(p, device=device)


def encoder_headers(enc: Encoder) -> bytes:
    return enc.headers()


def encoder_encode(enc: Encoder, pic_in: Optional[Picture]) -> List[bytes]:
    return enc.encode(pic_in)


def encoder_get_stats(enc: Encoder) -> Stats:
    return enc.get_stats()


def encoder_reconfig(enc: Encoder, p: Param) -> int:
    return enc.reconfig(p)


def encoder_reconfig_zone(enc: Encoder, zone_param: Param) -> int:
    return enc.reconfig_zone(zone_param)


def encoder_intra_refresh(enc: Encoder) -> int:
    return enc.intra_refresh()


def encoder_close(enc: Encoder):
    enc.close()


def check_params(p: Param):
    """x265_check_params subset + level enforcement (the
    enforceLevel/determineLevel analog, level.cpp:64,290): when the
    param pins a level_idc, the configured picture size / sample
    rate / bitrate must fit it unless b_allow_non_conformance."""
    if p.source_width <= 0 or p.source_height <= 0:
        raise ParamError("invalid source dimensions")
    if p.internal_bit_depth not in (8, 10):
        raise ParamError("bit depth must be 8 or 10")
    if not (0 <= p.rc.qp <= 69):
        raise ParamError("qp out of range")
    if p.level_idc and not getattr(p, "b_allow_non_conformance", 0):
        fps = (p.fps_num or 25) / max(p.fps_denom or 1, 1)
        need = pick_level(p.source_width, p.source_height, fps,
                          p.rc.bitrate or 0)
        if need > p.level_idc:
            raise ParamError(
                f"configuration requires level {need / 30:.1f} but "
                f"level_idc pins {p.level_idc / 30:.1f} "
                f"(use allow-non-conformance to override)")


# -- the rest of the public API (x265.h: x265_cleanup, x265_dither_image,
# x265_calculate_vmaf, x265_get_slicetype_poc_and_scenecut,
# x265_get_ref_frame_list, x265_set_analysis_data) -------------------------

def cleanup():
    """x265_cleanup: there is no global state to free."""


def dither_image(plane16: np.ndarray, bit_depth_in: int,
                 bit_depth_out: int = 8) -> np.ndarray:
    """x265_dither_image: one plane from bit_depth_in down to
    bit_depth_out bits by error diffusion along each row (the running
    error of each sample carried to the next; uint8 out at 8 bits or
    fewer, else uint16). The rows run side by side, column by column."""
    if bit_depth_in == bit_depth_out:
        return plane16.astype(np.uint8 if bit_depth_out <= 8 else np.uint16)
    shift = bit_depth_in - bit_depth_out
    half = 1 << (shift - 1)
    maxv = (1 << bit_depth_out) - 1
    src = plane16.astype(np.int32)
    out = np.zeros_like(src)
    err = np.zeros(src.shape[0], np.int32)
    for xx in range(src.shape[1]):
        v = src[:, xx] + err
        q = np.clip((v + half) >> shift, 0, maxv)
        err = v - (q << shift)
        out[:, xx] = q
    return out.astype(np.uint8 if bit_depth_out <= 8 else np.uint16)


VMAF_AVAILABLE = False


def calculate_vmaf(*_args, **_kw):
    """x265_calculate_vmaf: this build has no libvmaf (the reference built
    without ENABLE_LIBVMAF), so it raises RuntimeError."""
    raise RuntimeError("VMAF support not compiled in (libvmaf unavailable)")


def get_slicetype_poc_and_scenecut(enc: Encoder, pic_out=None) -> dict:
    """x265_get_slicetype_poc_and_scenecut: the slice type, POC and scene
    cut flag (1 for an I frame) of the last picture out; None / None / 0
    before the first."""
    st = getattr(enc, "_last_frame_info", None)
    if st is None:
        return {"sliceType": None, "poc": None, "bScenecut": 0}
    return dict(st)


def get_ref_frame_list(enc: Encoder) -> tuple:
    """x265_get_ref_frame_list: the POCs of the (L0, L1) references of the
    next picture, as the reference reports them: a B session's last
    anchor in L0, else nothing."""
    anchor = getattr(getattr(enc, "_sess", None), "anchor", None)
    return ([anchor[1]] if anchor else [], [])


def set_analysis_data(enc: Encoder, analysis) -> int:
    """x265_set_analysis_data: hand the encoder analysis records (the
    --analysis-save format: a list of {"t": "I" | "P", "mvx", "mvy"}),
    read from the next frame on (the index starts again at 0). Returns 0,
    or -1 for an encoder whose session takes no records (all-intra)."""
    sess = getattr(enc, "_sess", None)
    if sess is None or not hasattr(sess, "analysis_data"):
        return -1
    sess.analysis_data = analysis
    sess.analysis_idx = 0
    return 0
