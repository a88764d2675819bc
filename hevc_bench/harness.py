"""One run of one cell: set-up, the measured window, the check, the line.

The cell (an entry of BENCHMARK.json's `workloads`) names a configuration
(hevc_bench/configs/<config>.json: the x265 command line and the input
format) and a traffic mix (hevc_bench/traffic/<mix>.json, read by
content.py). The run builds the session as the port's command line does
(`cli.parse`, then `cli.configure`) and feeds it generated frames through
the call `cli.main` makes for a session with B frames (`push_frame`),
keeping the NAL units in memory.

  * Set-up: imports, the port's two native libraries (built on the first
    run into the port's own build directory, inside the checkout), the
    content's textures, the session, and frames pushed until the IDR and
    the first mini-GOP have come back, so that the I, P and B programs
    have each run once (a configuration's `warmup_minigops` asks for
    more mini-GOPs).
  * Window: from the return of the set-up's last frames, frames are pushed
    until the first call that returns frames at or after `seconds`. Every
    frame returned in between counts.
  * Trace (`--trace 1`): after the window, frames are pushed until the
    session's next P anchor and B frame have each been encoded under the
    profiler (trace.py), so that the profiler slows no frame of the window
    and the stage metrics read the same frames an untraced run times.
  * Check (after the window, with the session freed): the whole stream
    decoded by an independent decoder must give back the encoder's
    reconstruction of every frame, sample for sample, and every K1 answer
    of the window must equal the plain search's (reference.py, k1.py).
  * Metrics: each metric of the cell is read by hevc_bench/metrics/<name>.py
    (`read(ctx)`, None where it finds nothing to read).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "x265_yuuki_asuna_tpu")
CACHE_VARS = ("CUDA_CACHE_PATH",)
FAULTS = ("stale_reference", "flipped_bit", "k1_answer", "half_blocks")
RUN_LIMIT_S = 240        # the window's hard end, past `seconds`


def log(*a):
    print("[hevc_bench]", *a, file=sys.stderr, flush=True)


def forbidden_modules(names=None):
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str, bench: dict = None):
    """(workload, config, mix) of the cell `name`."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return (wl, load_json(ROOT, cfg["file"]),
            load_json(HERE, "traffic", wl["traffic"] + ".json"))


def metrics_of(bench: dict, cell: str, kind: str):
    """The `end_to_end` or `per_layer` metrics the cell reports."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def reader(name: str):
    """hevc_bench/metrics/<name>.py, loaded by its path."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "hevc_bench.metrics." + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_age_s() -> float:
    """Seconds since this process started (/proc)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def _read(path: str, default=""):
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return default


def card_pci_id(props) -> str:
    """The card's PCI address as /sys names it ("" where torch does not
    give it)."""
    ids = [getattr(props, f"pci_{k}_id", None)
           for k in ("domain", "bus", "device")]
    return "" if None in ids else "%04x:%02x:%02x.0" % tuple(ids)


def card_numa_cpus(pci_bus_id: str):
    """(NUMA nodes of the machine, the card's node, that node's CPUs)
    from /sys; the node is -1 and the CPUs None where /sys does not say."""
    nodes = [d for d in os.listdir("/sys/devices/system/node")
             if d.startswith("node") and d[4:].isdigit()] \
        if os.path.isdir("/sys/devices/system/node") else []
    node = int(_read(f"/sys/bus/pci/devices/{pci_bus_id}/numa_node", "-1")
               if pci_bus_id else -1)
    cpus = None
    if node >= 0:
        cpus = set()
        for part in _read(f"/sys/devices/system/node/node{node}/cpulist") \
                .split(","):
            if part:
                a, _, b = part.partition("-")
                cpus.update(range(int(a), int(b or a) + 1))
    return len(nodes), node, cpus or None


def bind_to_card_node(pci_bus_id: str) -> dict:
    """Keeps this process on the CPUs of the card's NUMA node (a no-op on
    a machine of one node) and returns what the host is, for the line."""
    n_nodes, node, cpus = card_numa_cpus(pci_bus_id)
    if n_nodes > 1 and cpus:
        os.sched_setaffinity(0, cpus)
    cpu = os.sched_getaffinity(0)
    info = _read("/proc/cpuinfo").split("\n\n")[0]
    field = lambda k: next((ln.split(":", 1)[1].strip()
                            for ln in info.splitlines() if ln.startswith(k)),
                           "")
    return {"cpu_model": field("model name"), "cpu_mhz": field("cpu MHz"),
            "cpus": len(cpu), "numa_nodes": n_nodes, "card_numa_node": node,
            "pythonhashseed": os.environ.get("PYTHONHASHSEED")}


def host_probe_ms() -> float:
    """The best of three timings of a fixed pure-Python loop: the host
    core's speed as this process sees it, read after the window."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        acc = 0
        for k in range(300_000):
            acc += k * k % 7
        best = min(best, time.perf_counter() - t)
    return 1e3 * best


def use_cache_dirs():
    """Every build and kernel cache a library might keep, at fixed
    directories inside the checkout."""
    for var in CACHE_VARS:
        path = os.path.join(HERE, ".cache", var.lower())
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


class Ctx:
    """What a metric reader reads: the window's frames (dicts: type,
    display, bits, psnr_y), its stage ms, its seconds, the set-up's, the
    frame rate, the tracer, the K1 launches made inside traced calls and
    the card's row of the table of peaks."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def stage_per_frame(self, *stages):
        """ms per window frame spent in the session's stages; None where
        the window spent nothing there."""
        ms = sum(self.stage_ms.get(s, 0.0) for s in stages)
        return ms / len(self.frames) if ms > 0 and self.frames else None


class Display:
    """Display index of each returned frame: a B session returns whole
    mini-GOPs in coding order, POCs counted from the last IDR; an IDR
    (POC 0) is the frame pushed in the call that returns it."""

    def __init__(self):
        self.base = 0

    def __call__(self, fr, pushed: int) -> int:
        if fr.frame_type == "I" and fr.poc == 0:
            self.base = pushed
        return self.base + fr.poc


def _faults(sess, fault, state):
    """Test faults planted in the session, each once, in the window."""
    if fault == "stale_reference":
        # the first P anchor of the window predicts from the picture the
        # DPB held before its last update, as if that update had left the
        # state unchanged
        orig = sess._encode_p_anchor
        held = []

        def stale(*a, **k):
            if state["armed"] and not state["done"] and held:
                state["done"] = True
                sess.anchor = (held[-1], sess.anchor[1])
            # a copy: the programs may write the next recon into the
            # same buffers
            held.append(tuple(p.clone() for p in sess.anchor[0])
                        if hasattr(sess.anchor[0][0], "clone")
                        else tuple(p.copy() for p in sess.anchor[0]))
            return orig(*a, **k)
        sess._encode_p_anchor = stale
    elif fault == "flipped_bit":
        orig_finish = sess._finish

        def flipped(*a, **k):
            fr = orig_finish(*a, **k)
            if state["armed"] and not state["done"]:
                state["done"] = True
                b = bytearray(fr.nals)
                b[len(b) * 3 // 4] ^= 0x10
                fr.nals = bytes(b)
            return fr
        sess._finish = flipped


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device=None, size=None, fault=None) -> dict:
    """One run; returns the result line's dict, or None when a forbidden
    module was loaded. device="cpu" and size=(w, h) run the port's plain
    versions at a small size (the tests)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    _, cfg, mix = load_cell(cell, bench)
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    import torch
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.models import encoder_top
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    from x265_yuuki_asuna_tpu_torch.utils import build
    from x265_yuuki_asuna_tpu_torch.utils import io as IO
    from x265_yuuki_asuna_tpu_torch.utils import param as P
    from . import k1, reference
    from .content import Content
    from .trace import Tracer

    on_card = device is None
    host = bind_to_card_node(
        card_pci_id(torch.cuda.get_device_properties(0)) if on_card else "")
    log(f"host: {host}")
    libs = ("me_sad", "asuna_native") if on_card else ("asuna_native",)
    fresh = [n for n in libs if not os.path.exists(build.lib_path(n))]
    tb = time.perf_counter()
    for name in libs:
        build.load(name)
    log(f"native libraries {list(libs)}: loaded in "
        f"{time.perf_counter() - tb:.3f} s, built now: {fresh or 'none'}")

    inp = cfg["input"]
    w, h = size or (inp["width"], inp["height"])
    fps_num, fps_den = inp["fps"]
    dev = torch.device("cuda") if on_card else torch.device(device)
    if on_card:
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    content = Content(mix, w, h, seed, dev)
    args, prm = cli.parse(["input.y4m", "-o", "output.hevc"] + cfg["argv"])
    info = IO.VideoInfo(w, h, fps_num, fps_den, P.CSP_I420, 8)
    sess = cli.configure(args, prm, info, device)
    if not getattr(sess, "bframes", 0):
        raise ValueError(f"{cell}: the harness drives sessions with B "
                         f"frames (push_frame) only")

    rec = k1.Recorder(me_sad, seed, fault)
    rec.install()
    state = {"armed": False, "done": False}
    _faults(sess, fault, state)
    tracer = Tracer() if trace else None
    timed = encoder_top._timed
    if tracer:
        encoder_top._timed = tracer.wrap_timed(timed)
        sess._encode_p_anchor = tracer.wrap(sess._encode_p_anchor, "P")
        sess._encode_b = tracer.wrap(sess._encode_b, "B")

    stream = [sess.headers()]
    recon, sources, coded = {}, {}, []
    display = Display()
    gen_s = [0.0, 0]

    def step(i):
        tg = time.perf_counter()
        frame = content.frame(i)
        gen_s[0] += time.perf_counter() - tg
        gen_s[1] += 1
        sources[i] = frame
        out = []
        for fr in sess.push_frame(*frame):
            d = display(fr, i)
            stream.append(fr.nals)
            recon[d] = fr.recon
            coded.append(d)
            out.append(dict(type=fr.frame_type, display=d, bits=fr.bits))
        return out

    # set-up: until the IDR and the configuration's number of mini-GOPs
    # (warmup_minigops, 1 by default) have come back
    i, types, anchors = 0, set(), 0
    while not ({"I", "P", "b"} <= types
               and anchors >= cfg.get("warmup_minigops", 1)):
        back = step(i)
        types |= {f["type"].replace("B", "b") for f in back}
        anchors += sum(f["type"] == "P" for f in back)
        i += 1
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age_s()
    log(f"set-up: {i} frames pushed, {len(coded)} back, {setup_s:.3f} s")

    # the window
    st0 = dict(sess.stage_ms)
    rec.keep = state["armed"] = True
    frames, gen_s[:], returns = [], [0.0, 0], []
    tw = time.perf_counter()
    while True:
        back = step(i)
        i += 1
        frames += back
        el = time.perf_counter() - tw
        if back:
            returns.append((round(el, 3), len(back)))
        if (back and el >= seconds) or el >= seconds + RUN_LIMIT_S:
            break
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - tw
    rec.keep = state["armed"] = False
    stage_ms = {k: v - st0.get(k, 0.0) for k, v in sess.stage_ms.items()}
    mem_peak = torch.cuda.max_memory_allocated() if on_card else 0
    host["probe_ms"] = host_probe_ms()
    log(f"window: {len(frames)} frames in {window_s:.3f} s; content "
        f"{1e3 * gen_s[0] / max(gen_s[1], 1):.2f} ms a frame "
        f"({100 * gen_s[0] / window_s:.3f}% of the window); K1 recorder "
        f"{1e3 * rec.wrapper_s:.1f} ms in all; host probe "
        f"{host['probe_ms']:.2f} ms; returns (s, frames): {returns}")

    if tracer:
        # the profiler's own start-up, then the next P anchor and B frame
        # under it; their frames join the stream and the check
        if on_card:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.zeros(1, device=dev).add_(1)
            torch.cuda.synchronize()
        tracer.armed = True
        for _ in range(2 * (sess.bframes + 1)):
            if tracer.complete():
                break
            step(i)
            i += 1
        tracer.armed = False

    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return None

    # the program's state goes before the reference runs
    rec.uninstall()
    encoder_top._timed = timed
    kind = torch.cuda.get_device_name(0) if on_card else str(dev)
    del sess, content
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    tc = time.perf_counter()
    try:
        decoded = reference.decode_hevc(b"".join(stream), w, h)
    except RuntimeError as e:
        log(f"decoder: {e}")
        decoded = []
    n_coded = len(coded)
    undecoded = max(n_coded - len(decoded), 0)
    mismatch, failed = 0, 0
    window_set = {f["display"] for f in frames}
    for d in sorted(recon):
        bad_d = reference.recon_mismatch(decoded[d], recon[d]) \
            if d < len(decoded) else None
        mismatch += bad_d or 0
        if d in window_set and bad_d != 0:
            failed += 1
    for f in frames:
        f["psnr_y"] = reference.psnr(decoded[f["display"]][0],
                                     sources[f["display"]][0]) \
            if f["display"] < len(decoded) else None
    kept = rec.kept()
    k1_bad = k1.check(kept, dev)
    log(f"check: {n_coded} frames decoded against the reconstruction, "
        f"{len(kept)} of the window's {rec.in_window} K1 answers searched "
        f"plainly, in {time.perf_counter() - tc:.3f} s")
    checks = {"frames_undecoded": [undecoded, 0],
              "recon_mismatch_samples": [mismatch, 0],
              "k1_mismatch": [k1_bad, 0]}
    correct = all(v <= lim for v, lim in checks.values())

    traced = []
    if tracer:
        for c in tracer.calls:
            ev = c["events"] or [(c["t0_ns"], c["t1_ns"], "")]
            first = (min(e[0] for e in ev) - c["t0_ns"]) / 1e6
            last = (c["t1_ns"] - max(e[1] for e in ev)) / 1e6
            log(f"traced {c['label']}: {(c['t1_ns'] - c['t0_ns']) / 1e9:.3f} "
                f"s, {len(c['events'])} device events, the first "
                f"{first:.3f} ms after its start, the last ending "
                f"{last:.3f} ms before its end")
        spans = [(c["t0_ns"], c["t1_ns"]) for c in tracer.calls]
        traced = [r for r in rec.launches
                  if any(a <= r["t_ns"] <= b for a, b in spans)]
    ctx = Ctx(frames=frames, stage_ms=stage_ms, window_s=window_s,
              setup_s=setup_s, fps_num=fps_num, fps_den=fps_den,
              tracer=tracer, k1_traced=traced,
              peaks=k1.peaks(kind) if on_card else None)
    metrics = {}
    for m in metrics_of(bench, cell, "per_layer" if trace else "end_to_end"):
        v = reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(frames), "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if on_card else str(dev),
                      "kind": kind, "count": 1,
                      "memory_peak_bytes": mem_peak}}
    if tracer:
        out["device"].update(busy_s=tracer.busy_s(),
                             window_s=tracer.window_s())
        out["breakdown"] = {"device_ops": tracer.top_device_ops(),
                            "idle_gaps": tracer.idle_gaps()}
    out["frame_types"] = "".join(f["type"] for f in frames)
    out["host"] = host
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
