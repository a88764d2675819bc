"""The P-chain frame pipeline across slots (port of
x265_yuuki_asuna_tpu/parallel/pipeline.py): the reference's frame
parallelism with a real dependency between slots.

x265 runs frame threads where frame k waits for frame k-1's recon rows
(frame.h:105); the reference runs a P-chain over a device mesh, slot k
coding frame k against the recon slot k-1 hands it with a `lax.ppermute`
at every pipeline step. Here slot k's program runs on its card and
stream (mesh.on), and the handoff is:

  * the sender records an event on its stream after submitting the frame;
  * the receiver's stream waits on that event, then reads the recon where
    it lies (one card: record_stream, so the caching allocator keeps the
    planes until the receiver's reads are done) or takes a copy onto its
    card (another card: a peer copy on the sender's stream).

The recon stays on the device through the chain. Each frame's decisions
are fetched a step later on a side stream of its card, after the event,
so the fetch neither waits for the work queued behind the frame nor
blocks the next step's launches. On the CPU every slot runs in the step
order, and the result is the same.

Only the steps where a slot has a frame run: the reference's fill
program also codes frames it discards, which changes no output.
"""

from __future__ import annotations

import torch

from .mesh import encoders_for, join, on


def _record(slot):
    """An event on the slot's stream after the work submitted so far
    (None on the CPU)."""
    if slot.stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(slot.stream)
    return ev


def _receive(sent, src, dst):
    """The recon planes `sent` = (planes, event) of slot src as slot dst's
    reference: dst's stream waits on the event, then reads them in place
    (one card) or copies them to its card (called under on(dst))."""
    planes, ev = sent
    if dst.stream is None:
        return planes
    dst.stream.wait_event(ev)
    if src.device == dst.device:
        for p in planes:
            p.record_stream(dst.stream)
        return planes
    # a peer copy on the sender's stream, ordered after its recon; the
    # receiver's current stream waits for it
    with torch.cuda.stream(src.stream):
        return tuple(p.to(dst.device, non_blocking=True) for p in planes)


def frame_pipeline_stream_fn(encoder, slots, n_batches: int, qp: int = 32):
    """fn(y[T, N, H, W], u, v, idr_y, idr_u, idr_v) -> the decision dicts
    [T][N] of T P-chains of N frames (N = the slot count, T = n_batches),
    every chain anchored at the IDR recon (idr_*): chain t's frame k at
    [t][k], coded by slot k against frame k-1's recon (frame 0: the
    IDR's). T + N - 1 steps; at step s slot k codes chain s - k, and takes
    a new reference exactly when that chain starts (the reference's
    nxt_active). encoder: an InterFrameEncoder (the uniform P program);
    qp: its QP. Planes: host arrays or tensors of the coded size."""
    N, T = len(slots), n_batches
    encs = encoders_for(encoder, slots)

    def run(y, u, v, idr_y, idr_u, idr_v):
        join(slots)
        out = [[None] * N for _ in range(T)]
        fetch = {s.device: torch.cuda.Stream(device=s.device)
                 for s in slots if s.stream is not None}
        with on(slots[0]):
            idr = encs[slots[0].device].upload(idr_y, idr_u, idr_v)
        sent, last = {}, []
        for s in range(T + N - 1):
            step = []
            for k, slot in enumerate(slots):
                t = s - k
                if not 0 <= t < T:
                    continue
                enc = encs[slot.device]
                with on(slot):
                    src = enc.upload(y[t][k], u[t][k], v[t][k])
                    ref = idr if k == 0 else _receive(
                        sent.pop((t, k - 1)), slots[k - 1], slot)
                    h = enc.submit_frame(*src, *ref, qp)
                    rec = enc.recon_planes(h) if k + 1 < N else None
                    ev = _record(slot)
                if rec is not None:
                    sent[t, k] = (rec, ev)
                step.append((t, k, slot, h, ev))
            for item in last:
                _fetch(out, item, encs, fetch)
            last = step
        for item in last:
            _fetch(out, item, encs, fetch)
        return out

    return run


def _fetch(out, item, encs, fetch) -> None:
    """Fetch a submitted frame's dict into out[t][k]: on CUDA on its
    card's fetch stream, after the frame's event."""
    t, k, slot, h, ev = item
    enc = encs[slot.device]
    if slot.stream is None:
        out[t][k] = enc.finish_frame(h)
        return
    fs = fetch[slot.device]
    with torch.cuda.device(slot.device), torch.cuda.stream(fs):
        fs.wait_event(ev)
        out[t][k] = enc.finish_frame(h)


def frame_pipeline_fn(encoder, slots, qp: int = 32):
    """fn(y[N, H, W], u, v, idr_y, idr_u, idr_v) -> the N decision dicts
    of one P-chain (the pipeline's fill): frame 0 references the IDR
    recon, frame k the recon slot k-1 hands slot k. Each dict equals the
    sequential chain's."""
    stream = frame_pipeline_stream_fn(encoder, slots, 1, qp)
    return lambda y, u, v, *idr: stream([y], [u], [v], *idr)[0]
