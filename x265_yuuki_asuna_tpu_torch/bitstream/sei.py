"""SEI payload writers and level choice (host copy of the parts of
x265_yuuki_asuna_tpu/bitstream/sei.py the sessions write: wrap_sei,
active_parameter_sets, user_data_unregistered, parse_master_display,
mastering_display, content_light_level, the HRD's buffering_period and
pic_timing, the HDR10+ T.35 metadata of user_data_t35,
hdr10plus_t35_payload, load_hdr10plus_json and hdr10plus_sei_for_frame,
pick_level).

Reference behavior (studied, not copied): encoder/sei.cpp, common/level.cpp.
"""

from __future__ import annotations

import json
import re
from typing import List, Optional, Tuple

from .bitio import BitWriter, wrap_nal, NAL_PREFIX_SEI

# payload types (spec D.2.1)
SEI_USER_DATA_T35 = 4
SEI_USER_DATA_UNREGISTERED = 5
SEI_ACTIVE_PARAMETER_SETS = 129
SEI_MASTERING_DISPLAY = 137
SEI_CONTENT_LIGHT_LEVEL = 144

# x265 writes its encoder-info string under this UUID (public constant)
X265_USER_DATA_UUID = bytes((0x2C, 0xA2, 0xDE, 0x09, 0xB5, 0x17, 0x47, 0xDB,
                             0xBB, 0x55, 0xA4, 0xFE, 0x7F, 0xC2, 0xFC, 0x4E))


def sei_message(payload_type: int, payload: bytes) -> bytes:
    """ff-byte extension coding of type and size + the payload."""
    out = bytearray()
    t = payload_type
    while t >= 255:
        out.append(255)
        t -= 255
    out.append(t)
    s = len(payload)
    while s >= 255:
        out.append(255)
        s -= 255
    out.append(s)
    out += payload
    return bytes(out)


def wrap_sei(messages: List[bytes], nal_type: int = NAL_PREFIX_SEI) -> bytes:
    bw = BitWriter()
    for m in messages:
        bw.write_bytes(m)
    bw.rbsp_trailing_bits()
    return wrap_nal(nal_type, bw.get_bytes())


def user_data_unregistered(info: str) -> bytes:
    return sei_message(SEI_USER_DATA_UNREGISTERED,
                       X265_USER_DATA_UUID + info.encode())


def active_parameter_sets() -> bytes:
    bw = BitWriter()
    bw.write_bits(0, 4)      # active_video_parameter_set_id
    bw.write_flag(1)         # self_contained_cvs_flag
    bw.write_flag(0)         # no_parameter_set_update_flag
    bw.write_ue(0)           # num_sps_ids_minus1
    bw.write_ue(0)           # active_seq_parameter_set_id[0]
    bw.write_bits(1, 1)      # payload bit_equal_to_one alignment
    bw.write_align_zero()
    return sei_message(SEI_ACTIVE_PARAMETER_SETS, bw.get_bytes())


def parse_master_display(s: str) -> Optional[Tuple]:
    """x265's --master-display string G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min),
    all integers, as a 10-tuple; None when it does not parse."""
    m = re.match(r"G\((\d+),(\d+)\)B\((\d+),(\d+)\)R\((\d+),(\d+)\)"
                 r"WP\((\d+),(\d+)\)L\((\d+),(\d+)\)", s.replace(" ", ""))
    return None if not m else tuple(int(x) for x in m.groups())


def mastering_display(vals: Tuple) -> bytes:
    """Mastering display colour volume (D.2.28): vals (Gx, Gy, Bx, By,
    Rx, Ry, WPx, WPy, Lmax, Lmin)."""
    bw = BitWriter()
    for v in vals[:8]:                   # primaries G, B, R and white point
        bw.write_bits(v, 16)
    bw.write_bits(vals[8], 32)           # max_display_mastering_luminance
    bw.write_bits(vals[9], 32)
    return sei_message(SEI_MASTERING_DISPLAY, bw.get_bytes())


def content_light_level(max_cll: int, max_fall: int) -> bytes:
    """Content light level information (D.2.35)."""
    bw = BitWriter()
    bw.write_bits(max_cll, 16)
    bw.write_bits(max_fall, 16)
    return sei_message(SEI_CONTENT_LIGHT_LEVEL, bw.get_bytes())


# ---------------------------------------------------------------------------
# HDR10+ dynamic metadata (SMPTE ST 2094-40 in an ITU-T T.35 registered
# user-data SEI): one record per frame from a hdr10plus_tool-style JSON,
# the default full-frame window only
# ---------------------------------------------------------------------------

def user_data_t35(payload: bytes) -> bytes:
    return sei_message(SEI_USER_DATA_T35, payload)


def hdr10plus_t35_payload(rec: dict) -> bytes:
    """One frame's HDR10+ record as an ST 2094-40 T.35 payload: the T.35
    header (country 0xB5, provider 0x003C, code 0x0001, application 4
    version 1), the window count, the targeted display's peak, per
    window MaxScl, AverageRGB and up to 15 luminance percentiles, then
    per window the Bezier tone-mapping curve when the record has one."""
    bw = BitWriter()
    bw.write_bits(0xB5, 8)            # itu_t_t35_country_code
    bw.write_bits(0x003C, 16)         # terminal_provider_code
    bw.write_bits(0x0001, 16)         # terminal_provider_oriented_code
    bw.write_bits(4, 8)               # application_identifier
    bw.write_bits(1, 8)               # application_version
    num_windows = int(rec.get("NumberOfWindows", 1))
    bw.write_bits(num_windows, 2)
    bw.write_bits(int(rec.get("TargetedSystemDisplayMaximumLuminance", 0)),
                  27)
    bw.write_bits(0, 1)    # targeted_system_display_actual_peak_luminance
    lum = rec.get("LuminanceParameters", {})
    maxscl = lum.get("MaxScl", [0, 0, 0])
    for _ in range(num_windows):
        for v in maxscl[:3]:
            bw.write_bits(int(v), 17)
        bw.write_bits(int(lum.get("AverageRGB", 0)), 17)
        dists = lum.get("LuminanceDistributions", {})
        perc = dists.get("DistributionIndex", [])
        vals = dists.get("DistributionValues", [])
        n = min(len(perc), len(vals), 15)
        bw.write_bits(n, 4)
        for i in range(n):
            bw.write_bits(int(perc[i]), 7)
            bw.write_bits(int(vals[i]), 17)
        bw.write_bits(0, 10)          # fraction_bright_pixels
    bw.write_bits(0, 1)    # mastering_display_actual_peak_luminance_flag
    bez = rec.get("BezierCurveData")
    for _ in range(num_windows):
        if bez:
            bw.write_bits(1, 1)       # tone_mapping_flag
            bw.write_bits(int(bez.get("KneePointX", 0)), 12)
            bw.write_bits(int(bez.get("KneePointY", 0)), 12)
            anchors = bez.get("Anchors", [])[:15]
            bw.write_bits(len(anchors), 4)
            for a in anchors:
                bw.write_bits(int(a), 10)
        else:
            bw.write_bits(0, 1)
        bw.write_bits(0, 1)           # color_saturation_mapping_flag
    bw.write_align_zero()
    return bytes(bw.get_bytes())


def load_hdr10plus_json(path: str):
    """The per-frame records of a hdr10plus_tool-style JSON (its
    "SceneInfo", or "frames", or a top-level list); [] when the file
    cannot be read or parsed."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    if isinstance(doc, dict):
        return doc.get("SceneInfo", doc.get("frames", []))
    if isinstance(doc, list):
        return doc
    return []


def hdr10plus_sei_for_frame(records, display_idx: int) -> bytes:
    """The prefix-SEI NAL carrying the HDR10+ metadata of the frame at
    display_idx (past the records' end, the last record's); b"" with no
    records or when the record cannot be coded."""
    if not records:
        return b""
    rec = records[min(display_idx, len(records) - 1)]
    try:
        payload = hdr10plus_t35_payload(rec)
    except (KeyError, TypeError, ValueError):
        return b""
    return wrap_sei([user_data_t35(payload)])


# ---------------------------------------------------------------------------
# HRD SEI (spec D.2.2 buffering_period, D.2.3 pic_timing), for a session
# whose VUI carries hrd_parameters (headers._write_hrd: 24-bit delay
# fields, one NAL CPB, no sub-picture timing)
# ---------------------------------------------------------------------------

def buffering_period(initial_delay_90k: int,
                     initial_offset_90k: int = 0) -> bytes:
    """buffering_period SEI (payload type 0), delays in 90 kHz ticks."""
    bw = BitWriter()
    bw.write_ue(0)                       # bp_seq_parameter_set_id
    bw.write_flag(0)                     # concatenation_flag
    bw.write_bits(0, 24)                 # au_cpb_removal_delay_delta_minus1
    d = min(max(int(initial_delay_90k), 1), (1 << 24) - 1)
    o = min(max(int(initial_offset_90k), 0), (1 << 24) - 1)
    bw.write_bits(d, 24)                 # nal_initial_cpb_removal_delay[0]
    bw.write_bits(o, 24)                 # nal_initial_cpb_removal_offset[0]
    bw.rbsp_trailing_bits()
    return sei_message(0, bw.get_bytes())


def pic_timing(au_removal_delay_minus1: int, dpb_output_delay: int) -> bytes:
    """pic_timing SEI (payload type 1): the CPB removal and DPB output
    delays (no frame_field_info)."""
    bw = BitWriter()
    bw.write_bits(min(au_removal_delay_minus1, (1 << 24) - 1), 24)
    bw.write_bits(min(dpb_output_delay, (1 << 24) - 1), 24)
    bw.rbsp_trailing_bits()
    return sei_message(1, bw.get_bytes())


# (level_idc, max_luma_samples, max_luma_sample_rate, main_tier_kbps)
LEVELS = (
    (30, 36864, 552960, 128),          # 1
    (60, 122880, 3686400, 1500),       # 2
    (63, 245760, 7372800, 3000),       # 2.1
    (90, 552960, 16588800, 6000),      # 3
    (93, 983040, 33177600, 10000),     # 3.1
    (120, 2228224, 66846720, 12000),   # 4
    (123, 2228224, 133693440, 20000),  # 4.1
    (150, 8912896, 267386880, 25000),  # 5
    (153, 8912896, 534773760, 40000),  # 5.1
    (156, 8912896, 1069547520, 60000), # 5.2
    (180, 35651584, 1069547520, 60000),   # 6
    (183, 35651584, 2139095040, 120000),  # 6.1
    (186, 35651584, 4278190080, 240000),  # 6.2
)


def pick_level(width: int, height: int, fps: float,
               bitrate_kbps: int = 0) -> int:
    """Smallest level covering the picture size, sample rate and bitrate."""
    samples = width * height
    rate = samples * max(fps, 1.0)
    for idc, max_s, max_rate, max_kbps in LEVELS:
        if samples <= max_s and rate <= max_rate and \
                (bitrate_kbps == 0 or bitrate_kbps <= max_kbps):
            return idc
    return LEVELS[-1][0]
