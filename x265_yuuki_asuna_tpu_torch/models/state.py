"""Carry a session's state into a port session.

The encoder has no weights; what an encode depends on is the session
state: the reference picture, the lookahead's previous lowres plane, the
GOP counters and the rate-control history. `load_session_state` sets them
on a port `VideoEncoderSession`, e.g. from a JAX session part-way through a
GOP, so the port encodes the next frame exactly as that session would.
"""

from __future__ import annotations

import numpy as np
import torch

# rate-control history counters (RateControl attributes)
RC_KEYS = ("frame", "total_bits", "cplx_sum", "cplx_count",
           "short_term_cplx", "short_term_count", "last_qscale",
           "last_satd")


def load_session_state(sess, state: dict) -> None:
    """state keys:
      ref_y, ref_u, ref_v   padded reference planes (coded size; host
                            arrays, or anything np.asarray takes, e.g. the
                            JAX session's device planes)
      prev_lowres           the lookahead's previous lowres plane [lh, lw]
                            (absent or None: no previous frame)
      frame_idx, poc, display_idx
      rc_<name> for <name> in RC_KEYS, and rc_window_bits (a sequence)
    """
    if sess.bframes:
        raise NotImplementedError(
            "load_session_state for a session with bframes > 0: the "
            "mini-GOP state (pending frames, anchors) is a later slice's")
    planes = (state["ref_y"], state["ref_u"], state["ref_v"])
    shapes = ((sess.coded_h, sess.coded_w),
              (sess.coded_h // 2, sess.coded_w // 2),
              (sess.coded_h // 2, sess.coded_w // 2))
    for p, shp in zip(planes, shapes):
        if np.shape(p) != shp:
            raise ValueError(f"reference plane {np.shape(p)} != {shp}")
    if sess.max_depth:
        # the quadtree session keeps its reference on the device
        sess.ref = tuple(torch.as_tensor(np.array(p, np.uint8),
                                         device=sess.device) for p in planes)
    else:
        sess.ref = tuple(np.asarray(p, np.int32) for p in planes)
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
        if f"rc_{k}" in state:
            setattr(sess.rc, k, type(getattr(sess.rc, k))(state[f"rc_{k}"]))
    if "rc_window_bits" in state:
        sess.rc.window_bits = [int(b) for b in state["rc_window_bits"]]
