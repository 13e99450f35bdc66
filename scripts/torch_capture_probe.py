"""Card probe: CUDA-graph captures in one thread beside reads in another.

    python3 scripts/torch_capture_probe.py     (one CUDA card; ~30 s)

A background rebuild with `prewarm_rebuilds` captures its candidate's
sweep graphs (`kernels.LaunchGraph`, thread_local mode on a pooled side
stream) while serving threads replay the live generation's graphs and
copy results back on the readback side stream.  On one card, with two
`torch://` endpoints over 200,000 wildcard-schema docs (each prewarmed):
the 34-subject lookup batch's latency alone, beside a capture of the
other endpoint's 256-lane arena every 20 ms, and beside back-to-back
captures (the reader's batches counted meanwhile); then which syncs a
thread may make while another thread's capture is open (a stream sync,
a `.tolist()`, an event sync, a device sync — the last is refused by
CUDA and invalidates the other thread's capture, whose thread then
raises; the script reports both and ends)."""

import faulthandler
import os
import sys
import threading
import time

import numpy as np

WILDCARD = ("definition user {}\ndefinition doc {\n"
            "  relation viewer: user | user:*\n  relation banned: user\n"
            "  permission view = viewer - banned\n}")


def _ms(xs) -> str:
    return "p50 %.2f ms max %.2f ms" % (np.median(xs) * 1e3, max(xs) * 1e3)


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef

    if not torch.cuda.is_available():
        print("torch_capture_probe: no CUDA device", file=sys.stderr)
        return 2
    rels = [f"doc:d{i}#viewer@user:u{i % 97}" for i in range(200_000)]
    bs = Bootstrap(WILDCARD, "\n".join(rels))
    ep = create_endpoint("torch://?dispatch=direct", bs)
    ep.warm_start(prewarm=True)
    ep2 = create_endpoint("torch://?dispatch=direct", bs)
    ep2.warm_start(prewarm=True)
    subs = [SubjectRef("user", f"u{i}") for i in range(0, 97, 3)]
    g2 = ep2.graph()
    kc, snap = g2.kernel, g2.snapshot()
    arena = kc.take_arena(8)

    def read():
        ep._lookup_batch_sync("doc", "view", subs)

    def reads(n, tag):
        lat = []
        for _ in range(n):
            t = time.perf_counter()
            read()
            lat.append(time.perf_counter() - t)
        print(tag, "reads", n, _ms(lat), flush=True)

    caps = []

    def capture_loop(n, gap):
        for _ in range(n):
            t = time.perf_counter()
            kc._capture(arena, tuple(snap), 8, snap.plan)
            caps.append(time.perf_counter() - t)
            if gap:
                time.sleep(gap)

    reads(20, "alone")
    th = threading.Thread(target=capture_loop, args=(40, 0.02))
    th.start()
    reads(20, "beside captures every 20 ms")
    th.join()
    print("captures %d," % len(caps), _ms(caps), flush=True)
    caps.clear()
    # a stuck reader shows up as a stack dump
    faulthandler.dump_traceback_later(6, exit=False)
    th = threading.Thread(target=capture_loop, args=(400, 0))
    th.start()
    t0 = time.perf_counter()
    done = [0]

    def reader():
        while th.is_alive():
            read()
            done[0] += 1

    rt = threading.Thread(target=reader)
    rt.start()
    th.join()
    rt.join()
    faulthandler.cancel_dump_traceback_later()
    print("back-to-back captures %d in %.2f s," % (
        len(caps), time.perf_counter() - t0), _ms(caps),
        "; reader batches meanwhile %d" % done[0], flush=True)

    # the syncs another thread may make while a capture is open
    release, opened = threading.Event(), threading.Event()

    def hold_capture():
        g, s = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        with torch.cuda.stream(s):
            g.capture_begin(capture_error_mode="thread_local")
            opened.set()
            release.wait(10)
            x = torch.zeros(4, device="cuda")
            x += 1
            g.capture_end()

    def event_sync():
        e = torch.cuda.Event()
        e.record()
        e.synchronize()

    th = threading.Thread(target=hold_capture)
    th.start()
    opened.wait(10)
    for name, fn in (
            ("stream sync", lambda: torch.cuda.current_stream().synchronize()),
            ("tolist", lambda: torch.ones(3, device="cuda").tolist()),
            ("event sync", event_sync),
            ("device sync", torch.cuda.synchronize)):
        try:
            t = time.perf_counter()
            fn()
            print(name, "ok %.2f ms" % ((time.perf_counter() - t) * 1e3),
                  flush=True)
        except RuntimeError as e:
            print(name, "FAILED", str(e).splitlines()[0], flush=True)
    release.set()
    th.join(timeout=30)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
