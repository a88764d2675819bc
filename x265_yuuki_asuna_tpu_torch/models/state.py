"""Carry a session's state into a port session.

The encoder has no weights; what an encode depends on is the session
state: the reference picture, the lookahead's previous lowres plane, the
GOP counters and the rate-control history, and with two references,
TMVP or frame duplication the state those options carry (the second
reference, the collocated motion field, the previous source luma).
`load_session_state` sets them
on a port `VideoEncoderSession`, e.g. from a JAX session part-way through a
GOP, so the port encodes the next frame exactly as that session would.
"""

from __future__ import annotations

import numpy as np
import torch

# rate-control state (RateControl attributes): the history counters, the
# CRF / ABR / VBV state (each present only in its modes; la_blur and
# _last_rceq only after their first use) and each slice type's bits
# predictor, as pred_<I|P|B>_<coeff|count|offset>
RC_KEYS = ("frame", "total_bits", "cplx_sum", "cplx_count",
           "short_term_cplx", "short_term_count", "last_qscale",
           "last_satd", "la_blur", "rate_factor", "cplxr_sum",
           "wanted_bits_window", "buffer_fill", "amortize_per_frame",
           "amortize_left", "_last_rceq") + tuple(
               f"pred_{t}_{a}" for t in "IPB"
               for a in ("coeff", "count", "offset"))


def rc_state(rc) -> dict:
    """The rc_<name> entries of a session state (see load_session_state)
    from a RateControl, of this package or the JAX one: every RC_KEYS
    attribute it has, and its window_bits."""
    st = {"rc_window_bits": list(rc.window_bits)}
    for k in RC_KEYS:
        if k.startswith("pred_"):
            _, t, a = k.split("_")
            st["rc_" + k] = getattr(rc.pred[t], a)
        elif hasattr(rc, k):
            st["rc_" + k] = getattr(rc, k)
    return st


def _ref_planes(sess, state: dict, name: str):
    """The padded planes state[name + "_y" / "_u" / "_v"] as the session
    keeps a reference: device tensors in the device plane type of its bit
    depth (int16 above 8 bits) on the quadtree, int32 host arrays on the
    uniform grid."""
    planes = tuple(state[f"{name}_{c}"] for c in "yuv")
    shapes = ((sess.coded_h, sess.coded_w),
              (sess.coded_h // 2, sess.coded_w // 2),
              (sess.coded_h // 2, sess.coded_w // 2))
    for p, shp in zip(planes, shapes):
        if np.shape(p) != shp:
            raise ValueError(f"reference plane {np.shape(p)} != {shp}")
    if sess.max_depth:
        dt = np.uint8 if sess.bit_depth <= 8 else np.int16
        return tuple(torch.as_tensor(np.array(p, dt), device=sess.device)
                     for p in planes)
    return tuple(np.asarray(p, np.int32) for p in planes)


def load_session_state(sess, state: dict) -> None:
    """state keys:
      ref_y, ref_u, ref_v   padded reference planes (coded size; host
                            arrays, or anything np.asarray takes, e.g. the
                            JAX session's device planes)
      ref2_y, ref2_u, ref2_v
                            n_refs=2: the second L0 reference's planes
                            (absent or None: none, after an IDR)
      col_field             TMVP: the last frame's motion field {intra,
                            mvx, mvy, ref: [rows, cols], ref_deltas}
                            (absent or None: none)
      last_ref_deltas       the POC distances of the last P frame's
                            references (default [1])
      prev_src_y            frame_dup: the previous source luma (absent or
                            None: none)
      prev_lowres           the lookahead's previous lowres plane [lh, lw]
                            (absent or None: no previous frame)
      frame_idx, poc, display_idx
      rc_<name> for <name> in RC_KEYS, and rc_window_bits (a sequence);
                            only the ones given are set (rc_state makes
                            them)
    """
    if sess.bframes:
        raise NotImplementedError(
            "load_session_state for a session with bframes > 0: the "
            "mini-GOP state (pending frames, anchors) is a later slice's "
            "(ROADMAP Queue 1 item 12)")
    sess.ref = _ref_planes(sess, state, "ref")
    if state.get("ref2_y") is not None:
        sess.ref2 = _ref_planes(sess, state, "ref2")
    else:
        sess.ref2 = None
    col = state.get("col_field")
    sess.col_field = None if col is None else {
        "intra": np.asarray(col["intra"], bool),
        **{k: np.asarray(col[k], np.int32) for k in ("mvx", "mvy", "ref")},
        "ref_deltas": [int(d) for d in col["ref_deltas"]]}
    sess._last_ref_deltas = [int(d) for d in
                             state.get("last_ref_deltas", [1])]
    prev_y = state.get("prev_src_y")
    sess._prev_src_y = None if prev_y is None else np.array(prev_y)
    prev = state.get("prev_lowres")
    la = sess.lookahead
    if prev is None:
        la.prev_lowres = None
    else:
        if np.shape(prev) != (la.lh, la.lw):
            raise ValueError(f"prev_lowres {np.shape(prev)} != "
                             f"{(la.lh, la.lw)}")
        la.prev_lowres = torch.as_tensor(np.array(prev, np.int32),
                                         device=la.device)
    sess.frame_idx = int(state["frame_idx"])
    sess.poc = int(state["poc"])
    sess.display_idx = int(state["display_idx"])
    for k in RC_KEYS:
        if f"rc_{k}" not in state:
            continue
        obj, name = sess.rc, k
        if k.startswith("pred_"):
            _, t, name = k.split("_")
            obj = sess.rc.pred[t]
        # ints stay ints (frame, amortize_left), the rest are floats
        cast = int if isinstance(getattr(obj, name, 0.0), int) else float
        setattr(obj, name, cast(state[f"rc_{k}"]))
    if "rc_window_bits" in state:
        sess.rc.window_bits = [int(b) for b in state["rc_window_bits"]]
