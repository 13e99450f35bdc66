"""Card probe: a kernel batch's device time, four ways.

    python3 scripts/torch_devtime_probe.py [--trace]   (one CUDA card; ~2 min)

On a `torch://?dispatch=direct` endpoint over a small multitenant graph
(20,000 pods, 60,000 tuples; the Leopard index off, so pod#view sweeps),
each 256-lane `pod#view` lookup batch is timed by

- the endpoint's device window (`kernels.DeviceWindow`, summed into
  `authz_kernel_time_seconds{phase=kernel.device}`): the seed and sweep
  graphs' own event nodes, and an event pair inside each launcher's C
  call for launches outside a graph;
- the probe's own events inside the same graphs (chip_smoke's
  `_OwnGraphMarks`, as phase 18 (d) holds the window against them);
- one event pair recorded from Python around the whole batch call (the
  window the port used before: it holds the host's time between sweeps);
- in a second, profiled run of the same batches, the card's activity
  records (torch.profiler / CUPTI): each graph launch's first-node start
  to last-node end, plus each launch outside a graph.  The profiler slows
  the host's submissions, so the windows of that run are printed apart.

Each set runs quiet, then beside a thread that keeps the interpreter
lock busy (as the proxy's event loop does while a batch runs); then a
512-lane batch (its first sweep launched step by step, then captured)
and a segment-kernel endpoint's batches (every launch outside a graph).
With `--trace` the quiet set's profiled trace goes to
chiprun_out/devtime_trace.json."""

import asyncio
import json
import os
import sys
import tempfile
import threading
import time

MARK = "probe.batch"


def traced_batch_seconds(prof, keep=None) -> list:
    """Per `MARK` range, in order: the device seconds of the work launched
    inside it outside any aten op (input uploads, the state copy and the
    readbacks are aten ops) — a graph launch as its span, any other
    launch as its activities' summed durations."""
    with tempfile.TemporaryDirectory() as tmp:
        path = keep or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    marks, ops, calls, device = [], {}, [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e.get("name") == MARK:
            marks.append((t0, t1, e["tid"]))
        elif cat == "cpu_op":
            ops.setdefault(e["tid"], []).append((t0, t1))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            calls.append((t0, e.get("name", ""), corr))
        elif cat in ("kernel", "gpu_memset", "gpu_memcpy") and corr is not None:
            device.setdefault(corr, []).append((t0, t1))
    out = []
    for m0, m1, tid in sorted(marks):
        inside = [o for o in ops.get(tid, ()) if m0 <= o[0] <= m1]
        s, seen = 0.0, set()
        for t, name, corr in calls:
            if not m0 <= t <= m1 or corr not in device or corr in seen:
                continue
            if any(o0 <= t <= o1 for o0, o1 in inside):
                continue
            seen.add(corr)
            acts = device[corr]
            if "GraphLaunch" in name:
                s += max(b for _, b in acts) - min(a for a, _ in acts)
            else:
                s += sum(b - a for a, b in acts)
        out.append(s / 1e6)
    return out


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("torch_devtime_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef

    w = workloads.multitenant_1m(n_pods=20_000, n_tuples=60_000,
                                 n_users=600, n_namespaces=200)
    bs = Bootstrap(w.schema_text, "\n".join(w.relationships))
    marks = chip_smoke._OwnGraphMarks()
    windows = []
    seconds = kernels.DeviceWindow.seconds

    def logged(win):
        out = seconds(win)
        windows.append((out, win.graph_s))
        return out

    kernels.DeviceWindow.seconds = logged

    def ms(xs):
        return [round(x * 1e3, 4) for x in xs]

    def run_set(ep, tag, subjects, n, hog, keep=None):
        graph = ep.graph()
        orig = graph.run_lookup_packed_T_device
        outer = []

        def whole(*a, **k):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            with record_function(MARK):
                out = orig(*a, **k)
            e.record()
            outer.append((s, e))
            return out

        stop = threading.Event()

        def busy():
            while not stop.is_set():
                sum(range(20_000))

        th = threading.Thread(target=busy, daemon=True) if hog else None
        if th:
            th.start()
        graph.run_lookup_packed_T_device = whole
        try:
            del windows[:], marks.spans[:]
            marks.on = True
            t0 = time.perf_counter()
            for _ in range(n):
                asyncio.run(ep.lookup_resources_batch("pod", "view",
                                                      subjects))
            host = time.perf_counter() - t0
            marks.on = False
            plain, own = list(windows), list(marks.spans)
            whole_ms = [s.elapsed_time(e) for s, e in outer]
            del windows[:]
            try:
                from torch._C._profiler import _ExperimentalConfig
                cfg = dict(experimental_config=_ExperimentalConfig(
                    profile_all_threads=True))
            except (ImportError, TypeError):
                cfg = {}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA], **cfg) as prof:
                for _ in range(n):
                    asyncio.run(ep.lookup_resources_batch("pod", "view",
                                                          subjects))
            profiled = list(windows)
        finally:
            marks.on = False
            del graph.run_lookup_packed_T_device
            if th:
                stop.set()
                th.join()
        traced = traced_batch_seconds(prof, keep)
        acc, mine = sum(x[0] for x in plain), sum(own)
        print(f"{tag}: {n} batches, host {host * 1e3:.3f} ms\n"
              f"  window ms {ms(x[0] for x in plain)} (graph spans "
              f"{ms(x[1] for x in plain)}); sum {acc * 1e3:.4f}\n"
              f"  own in-graph events sum {mine * 1e3:.4f} ms over "
              f"{len(own)} replays "
              f"({(acc / mine - 1) * 100 if mine else float('nan'):+.3f} %)\n"
              f"  whole-call events ms {[round(x, 4) for x in whole_ms]}\n"
              f"  profiled run: window ms {ms(x[0] for x in profiled)}, "
              f"activity records ms {ms(traced)}", flush=True)

    ep = create_endpoint("torch://?dispatch=direct", bs, leopard=False)
    t = time.perf_counter()
    ep.warm_start(prewarm=True)
    print(f"warm start with prewarm {time.perf_counter() - t:.2f} s",
          flush=True)
    subs = [SubjectRef("user", u) for u in w.subjects[:256]]
    asyncio.run(ep.lookup_resources_batch("pod", "view", subs))
    keep = None
    if "--trace" in sys.argv:
        os.makedirs("chiprun_out", exist_ok=True)
        keep = "chiprun_out/devtime_trace.json"
    run_set(ep, "ell 256 quiet", subs, 4, False, keep)
    run_set(ep, "ell 256 hog", subs, 8, True)
    wide = [SubjectRef("user", u) for u in w.subjects[:512]]
    run_set(ep, "ell 512 first (eager sweep + capture)", wide, 1, False)
    run_set(ep, "ell 512 hog", wide, 4, True)
    seg = create_endpoint("torch://?dispatch=direct&kernel=segment", bs,
                          leopard=False)
    seg.warm_start(prewarm=True)
    asyncio.run(seg.lookup_resources_batch("pod", "view", subs))
    run_set(seg, "segment 256 quiet", subs, 4, False)
    run_set(seg, "segment 256 hog", subs, 4, True)
    marks.uninstall()
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
