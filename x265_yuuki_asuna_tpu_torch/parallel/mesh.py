"""Pipeline slots, and the frame- and band-parallel strategies (port of
x265_yuuki_asuna_tpu/parallel/mesh.py).

The reference runs its strategies as `shard_map` programs over a mesh of
JAX devices. The port's counterpart of a device is a slot, a
(torch.device, stream) pair:

  * on CUDA each slot has a stream of its own, and slots wrap round-robin
    over the cards: slot k is on card k % the card count, so on a
    one-card machine four slots are four streams of one card (the
    counterpart of the reference's virtual CPU devices);
  * with device="cpu" every slot is the CPU, and the work runs in the
    reference's step order.

What a slot codes depends only on the number of slots, never on the
cards. Each slot's work runs on its card and its stream (`on`), so K1's
launches (`ops/kernels/me_sad._launch`) land on the slot's stream.

  * frame parallel — one uniform intra frame per slot (the reference's
    frame threads): each frame's dict equals IntraFrameEncoder's;
  * band parallel — one slice band of one picture per slot (--slices):
    the bands' dicts assemble into the sliced session's stream.
"""

from __future__ import annotations

import contextlib
import sys
from typing import List, NamedTuple, Optional

import torch

from ..utils.device import resolve_device


class Slot(NamedTuple):
    """One pipeline slot: its index, its device and, on CUDA, its stream
    (None on the CPU)."""
    index: int
    device: torch.device
    stream: Optional[torch.cuda.Stream]


def make_slots(n_devices: int = None, device=None, devices=None) \
        -> List[Slot]:
    """n_devices slots (None: one per card), the counterpart of the
    reference's make_mesh. device: None runs on the CUDA cards (and raises
    when there is none, as utils/device.resolve_device), "cpu" on the
    CPU; devices: the cards the slots wrap over (default: every card).
    Fewer than two slots fails the reference's assertion. Prints the
    slot-to-card map on stderr."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device(d) for d in devices] if devices else \
            [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    n = len(cards) if n_devices is None else n_devices
    assert n >= 2, "--devices needs >= 2 slots"
    slots = []
    for k in range(n):
        card = cards[k % len(cards)]
        slots.append(Slot(k, card, torch.cuda.Stream(device=card)
                          if card.type == "cuda" else None))
    print("slots: " + ", ".join(
        f"{s.index}->{s.device}" + (f" stream {s.stream.stream_id}"
                                    if s.stream is not None else "")
        for s in slots), file=sys.stderr)
    return slots


@contextlib.contextmanager
def on(slot: Slot):
    """Run the block on the slot's card and stream (nothing on the
    CPU)."""
    if slot.stream is None:
        yield
        return
    with torch.cuda.device(slot.device), torch.cuda.stream(slot.stream):
        yield


def join(slots) -> None:
    """Every slot's stream waits for its card's current stream (inputs
    made there before the slots start)."""
    for s in slots:
        if s.stream is not None:
            s.stream.wait_stream(torch.cuda.current_stream(s.device))


def encoders_for(encoder, slots) -> dict:
    """{slot device: the encoder on it} (the encoder itself on its own
    device, else its copy through encoder.to)."""
    out = {}
    for s in slots:
        if s.device not in out:
            out[s.device] = encoder if encoder.device == s.device else \
                encoder.to(s.device)
    return out


def _independent(encoder, slots, qp: int):
    """fn(y[B, H, W], u, v) -> B decision dicts: frame b coded on slot b
    (B = the slot count); every slot submits, then each fetches."""
    encs = encoders_for(encoder, slots)

    def run(y, u, v):
        if len(y) != len(slots):
            raise ValueError(f"{len(y)} frames for {len(slots)} slots")
        join(slots)
        handles = []
        for s, yy, uu, vv in zip(slots, y, u, v):
            with on(s):
                handles.append(encs[s.device].submit_frames(
                    [yy], [uu], [vv], qp))
        out = []
        for s, h in zip(slots, handles):
            with on(s):
                out += encs[s.device].finish_frames(h)
        return out

    return run


def frame_parallel_fn(encoder, slots, qp: int = 32):
    """fn(y[B, H, W], u, v) -> the B frames' decision dicts, one uniform
    intra frame per slot (encoder: an IntraFrameEncoder; B = the slot
    count; qp: every CU's QP). Each dict equals the encoder's
    encode_frames dict of the frame."""
    return _independent(encoder, slots, qp)


def band_parallel_fn(band_encoder, slots, qp: int = 32):
    """fn(y[B, band_h, W], u, v) -> the decision dicts of the B slice
    bands of one picture, one band per slot (band_encoder: the sliced
    IntraEncoderSession's frame_encoder, of one band's geometry). Each
    band is an independent slice, so the session's _band_slice writes
    them into its --slices picture."""
    return _independent(band_encoder, slots, qp)
