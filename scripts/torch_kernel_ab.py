#!/usr/bin/env python3
"""`lookup_T` and `scatter_rows` against their first versions and their
PyTorch yardsticks, on one CUDA card, with device time and host cost
apart.

    python3 scripts/torch_kernel_ab.py [--variants old,new,library]
                                       [--rounds 3] [--out FILE]

Loads multitenant-1m (`models/workloads.py multitenant_1m()` defaults)
into `create_endpoint("torch://")` as `chip_smoke.py` does (phase 3),
runs one 256-subject lookup batch to its converged state (phases 4-6),
then `--rounds` rounds of phase 9's churn, and takes the last round's
real flush.  On those inputs, at the main path's shapes:

  4c         lookup_T, definite state [8, pod rows] (rows of 8 words)
  4c_planes  lookup_T, the definite plane of rows of 16 words (the same
             state twice side by side: the caveat path's shape)
  8          scatter_rows, the flush of the main and aux tables
  11         scatter_rows, the segment flush's shape: two [cap, 1] edge
             arrays (cap from the store's edge count as the segment graph
             computes it), 212 seeded positions
  13         scatter_rows, the sharded flush's shape: the main and aux
             tables cut into 4 row blocks (a 2 x 4 mesh's graph shards),
             the flush's rows scattered into each block they touch

Variants: "old" is the first CUDA version of each kernel (one thread per
output word with 64-bit division; the copy and the scatter as two
launches), kept here as source and built beside the package's library so
that it can be measured and never reached from the path; "new" the
package's kernel; "library" one PyTorch call computing the same function
(`narrow().t().contiguous()`, `torch.index_put`).  Every variant is first
held bit for bit against the plain twin, then measured by
`chip_smoke.attribute`: (a) event-timed loop, (b) device-only time,
(c) host cost per call, (d) device time with L2 flushed.  Each row runs
the variants in the order given and then reversed (old, new, new, old),
and reports each reading.  Last, the host time of row 8's flush with
its rows and values sent in two pageable copies a table against one
pinned asynchronous copy (pageable, staged, staged, pageable).  Prints
the card's nvidia-smi line first and one JSON object last (and to
--out, if given, with the names of the device activities each variant
ran).  Needs one card.
"""

from __future__ import annotations

import argparse
import asyncio
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_POSITIONS = 212     # the segment flush's positions (PERF.md row 11)
MESH_GRAPH = 4          # graph shards of the 2 x 4 mesh (PERF.md row 13)

OLD_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#define EXPORT extern "C" __attribute__((visibility("default")))
namespace {
constexpr int kBlock = 256;
inline unsigned int grid_for(long long n, int block, long long cap) {
    long long g = (n + block - 1) / block;
    if (g < 1) g = 1;
    if (g > cap) g = cap;
    return (unsigned int)g;
}
__global__ void lookup_T_kernel(const int32_t* __restrict__ x, int W,
                                long long S, long long offset, long long L,
                                int32_t* __restrict__ out) {
    const long long total = L * W;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const long long w = t / L;
        const long long l = t - w * L;
        out[t] = x[(offset + l) * S + w];
    }
}
__global__ void copy_words_kernel(const int32_t* __restrict__ src,
                                  int32_t* __restrict__ out, long long n,
                                  int vec) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long done = 0;
    if (vec) {
        const long long n4 = n >> 2;
        const int4* __restrict__ s4 = reinterpret_cast<const int4*>(src);
        int4* __restrict__ o4 = reinterpret_cast<int4*>(out);
        for (long long t = t0; t < n4; t += stride) o4[t] = __ldg(s4 + t);
        done = n4 << 2;
    }
    for (long long t = done + t0; t < n; t += stride) out[t] = __ldg(src + t);
}
__global__ void scatter_rows_kernel(const int32_t* __restrict__ rows,
                                    const int32_t* __restrict__ vals,
                                    long long b, int K, long long R,
                                    int32_t* __restrict__ out) {
    const long long total = b * K;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const long long i = t / K;
        const int k = (int)(t - i * K);
        const long long r = __ldg(rows + i);
        if (r >= 0 && r < R) out[r * K + k] = __ldg(vals + t);
    }
}
}  // namespace
EXPORT int old_lookup_T(const void* x, int W, long long S, long long offset,
                        long long L, void* out, void* stream) {
    if (L <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    lookup_T_kernel<<<grid_for(L * W, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const int32_t*)x, W, S, offset, L, (int32_t*)out);
    return (int)cudaGetLastError();
}
EXPORT int old_scatter_rows(const void* src, long long R, int K,
                            const void* rows, long long b, const void* vals,
                            void* out, int vec, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long n = R * K;
    if (n > 0) {
        const long long work = vec ? (n >> 2) : n;
        copy_words_kernel<<<grid_for(work, kBlock, 132 * 32), kBlock, 0, s>>>(
            (const int32_t*)src, (int32_t*)out, n, vec);
        int e = (int)cudaGetLastError();
        if (e) return e;
    }
    if (b > 0 && K > 0) {
        scatter_rows_kernel<<<grid_for(b * K, kBlock, 1LL << 30), kBlock, 0,
                              s>>>(
            (const int32_t*)rows, (const int32_t*)vals, b, K, R,
            (int32_t*)out);
        return (int)cudaGetLastError();
    }
    return 0;
}
"""


def log(msg: str) -> None:
    print(msg, flush=True)


class OldKernels:
    """The first versions, built from OLD_SOURCE with the package's nvcc
    flags, behind wrappers with the first versions' host path."""

    def __init__(self):
        import torch
        from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
        self.torch, self.kernels = torch, kernels
        h = hashlib.sha256(OLD_SOURCE.encode()
                           + " ".join(kernels.NVCC_FLAGS).encode())
        out = kernels.BUILD_DIR / f"libold_kernels-{h.hexdigest()[:16]}.so"
        if not out.exists():
            kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            src = out.with_suffix(f".{os.getpid()}.cu")
            src.write_text(OLD_SOURCE)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                                   "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            src.unlink(missing_ok=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn, args in (("old_lookup_T", (P, I, L, L, L, P, P)),
                         ("old_scatter_rows", (P, L, I, P, L, P, P, I, P))):
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        self.lib = lib

    def _run(self, fn, device, *args):
        torch = self.torch
        with torch.cuda.device(device):
            code = getattr(self.lib, fn)(
                *args, torch.cuda.current_stream(device).cuda_stream)
        if code:
            raise RuntimeError(f"{fn}: CUDA error {code}")

    def lookup_T(self, x, offset, length, words=None):
        self.kernels._check(x, "x", 2)
        w = x.shape[1] if words is None else words
        out = self.torch.empty((w, length), dtype=self.torch.int32,
                               device=x.device)
        self._run("old_lookup_T", x.device, x.data_ptr(), w, x.shape[1],
                  offset, length, out.data_ptr())
        return out

    def scatter_rows(self, src, rows, vals):
        for t, name in ((src, "src"), (rows, "rows"), (vals, "vals")):
            self.kernels._check(t, name)
        r, k = src.shape
        out = self.torch.empty_like(src)
        vec = int(src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        self._run("old_scatter_rows", src.device, src.data_ptr(), r, k,
                  rows.data_ptr(), rows.shape[0], vals.data_ptr(),
                  out.data_ptr(), vec)
        return out


def churn_flush(ep, w, n_rounds: int):
    """Phase 9's first `n_rounds` rounds through the endpoint; returns the
    last round's pre-flush device tables and its (rows, vals) per table
    (main, aux), as the flush scattered them."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, SubjectRef, UpdateOp, parse_relationship)
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    plan = cs._churn_plan(w, n_rounds, cs.SEED + 9)
    readers = [SubjectRef("user", u) for u in w.subjects[:8]]

    async def commit(writes):
        for wr in writes:
            await ep.write_relationships(
                [RelationshipUpdate(ops[o], parse_relationship(r))
                 for o, r in wr])

    for r, rnd in enumerate(plan):
        g = ep.graph()
        prev_dev = g.snapshot()[:2]
        prev_host = (g.host_main.copy(), g.host_aux.copy())
        asyncio.run(commit(rnd["writes"]))
        asyncio.run(ep.lookup_resources_batch("pod", "view", readers))
        torch.cuda.synchronize()
    g = ep.graph()
    out = []
    for src, host_prev, host in zip(prev_dev, prev_host,
                                    (g.host_main, g.host_aux)):
        rows = np.nonzero((host != host_prev).any(axis=1))[0].astype(np.int32)
        out.append((src, torch.from_numpy(rows).to(src.device),
                    torch.from_numpy(np.ascontiguousarray(host[rows]))
                    .to(src.device)))
    return out


def staged_upload(device, *arrays) -> list:
    """int32 host arrays -> tensors on `device` in one transfer: packed
    into one pinned host buffer and copied asynchronously (torch's
    caching host allocator reuses the buffer once the copy has read it).
    Measured against the flush's two pageable copies and not taken into
    the flush (PERF.md §6)."""
    import numpy as np
    import torch
    arrs = [np.ascontiguousarray(a, np.int32) for a in arrays]
    sizes = [a.size for a in arrs]
    stage = torch.empty(sum(sizes), dtype=torch.int32, pin_memory=True)
    np.concatenate([a.ravel() for a in arrs], out=stage.numpy())
    flat = stage.to(device, non_blocking=True)
    return [t.view(a.shape) for t, a in zip(flat.split(sizes), arrs)]


def flush_host_us(work, staged: bool, reps: int = 50) -> float:
    """Median host µs of one flush of `work` ([(device table, host rows,
    host values)]): each table's rows and values sent to the card, then
    its `scatter_rows` launched.  `staged`: one pinned asynchronous copy
    a table (`staged_upload`); else the flush's two pageable copies
    (`_to_device`).  Synchronised between flushes, outside the timed
    span, as the read batches between flushes are."""
    import statistics

    import torch
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import _to_device
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for table, rows, vals in work:
            if staged:
                kernels.scatter_rows(table, *staged_upload(table.device,
                                                           rows, vals))
            else:
                kernels.scatter_rows(table, _to_device(rows, table.device),
                                     _to_device(vals, table.device))
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def blocks_of(table, rows, vals, n_blocks: int):
    """The table cut into `n_blocks` row blocks (own tensors, padded with
    the last row to a multiple), with each block's share of the flush."""
    import torch
    n = table.shape[0]
    b = -(-n // n_blocks)
    pad = b * n_blocks - n
    full = torch.cat([table, table[-1:].expand(pad, -1)]) if pad else table
    work = []
    for gi in range(n_blocks):
        sel = (rows >= gi * b) & (rows < (gi + 1) * b)
        if not bool(sel.any()):
            continue
        blk = full[gi * b: (gi + 1) * b].clone()
        work.append((blk, (rows[sel] - gi * b).contiguous(),
                     vals[sel].contiguous()))
    return work


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="old,new,library")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import bucket
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peak = cs.hbm_peak(name)
    log(smi)
    t0 = time.perf_counter()
    kernels.build()
    kernels._load()
    old = OldKernels()
    log(f"built in {time.perf_counter() - t0:.1f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log("  " + line.strip())

    ep, w = cs.load("cuda", {})
    g = ep.graph()
    kc, prog = g.kernel, g.prog
    main_t, aux_t, _ = g.snapshot()
    rng = np.random.default_rng(cs.SEED)
    batch = [SubjectRef("user", w.subjects[i]) for i in
             rng.choice(len(w.subjects), cs.LOOKUP_LANES, replace=False)]
    q_arr, _, _ = ep._encode_subjects(g, batch)
    n_words = len(q_arr) // 32
    q = torch.from_numpy(q_arr).cuda()
    x, _ = kc.evaluate(q, n_words, main_t, aux_t, kc.take_arena(n_words))
    x = x.clone()
    x_pl = torch.cat([x, x], dim=1).contiguous()
    off, length = prog.slot_range("pod", "view")
    cap = bucket(max(len(prog.edge_src) * 2, 1))
    flush = churn_flush(ep, w, args.rounds)
    seg_rows = torch.from_numpy(np.sort(rng.choice(
        cap, SEG_POSITIONS, replace=False)).astype(np.int32)).cuda()
    seg = [(torch.from_numpy(rng.integers(0, 1 << 20, (cap, 1))
                             .astype(np.int32)).cuda(), seg_rows,
            torch.from_numpy(rng.integers(0, 1 << 20, (SEG_POSITIONS, 1))
                             .astype(np.int32)).cuda()) for _ in range(2)]
    mesh = [a for t in flush for a in blocks_of(*t, MESH_GRAPH)]
    sources = flush + seg + mesh
    kept = [s.clone() for s, _, _ in sources]
    torch.cuda.synchronize()

    impl = {"old": old, "new": kernels}

    def lookup_fns(xx, words):
        lib = (lambda: xx.narrow(0, off, length).t().contiguous()) \
            if words == xx.shape[1] else \
            (lambda: xx.narrow(0, off, length)[:, :words].t().contiguous())
        return ({v: (lambda m=m: m.lookup_T(xx, off, length, words))
                 for v, m in impl.items()}, lib,
                lambda: reference.lookup_T(xx, off, length, words),
                2 * length * words * 4)

    def scatter_fns(work):
        lib = lambda: [torch.index_put(s, (r.long(),), v) for s, r, v in work]
        return ({v: (lambda m=m: [m.scatter_rows(*a) for a in work])
                 for v, m in impl.items()}, lib,
                lambda: [reference.scatter_rows(*a) for a in work],
                sum(2 * s.numel() * 4 + r.numel() * 4 + v.numel() * 4
                    for s, r, v in work))

    cases = {
        "4c": lookup_fns(x, n_words),
        "4c_planes": lookup_fns(x_pl, n_words),
        "8": scatter_fns(flush),
        "11": scatter_fns(seg),
        "13": scatter_fns(mesh),
    }
    shapes = {
        "4c": f"[{n_words}, {length}] of [{x.shape[0]}, {x.shape[1]}]",
        "4c_planes": f"[{n_words}, {length}] of [{x_pl.shape[0]}, "
                     f"{x_pl.shape[1]}]",
        "8": "; ".join(f"[{s.shape[0]}, {s.shape[1]}] with {r.numel()} rows"
                       for s, r, _ in flush),
        "11": f"2 x [{cap}, 1] with {SEG_POSITIONS} positions",
        "13": "; ".join(f"[{s.shape[0]}, {s.shape[1]}] with {r.numel()} rows"
                        for s, r, _ in mesh),
    }
    variants = args.variants.split(",")
    order = variants + variants[::-1]
    result = {"smi": smi, "device": name, "rows": {}}
    for case, (fns, lib, twin, nbytes) in cases.items():
        want = twin()
        want = want if isinstance(want, list) else [want]
        readings = {v: [] for v in variants}
        for v in order:
            fn = lib if v == "library" else fns[v]
            got = fn()
            got = got if isinstance(got, list) else [got]
            err = max(cs._diff(a, b) for a, b in zip(got, want))
            if err:
                raise AssertionError(f"{case}: {v} differs from the twin "
                                     f"by {err}")
            readings[v].append(cs.attribute(fn))
        row = {"shape": shapes[case],
               "bound_ms": nbytes / peak * 1e3, "bytes": nbytes,
               "readings": readings}
        result["rows"][case] = row
        for v in variants:
            rs = readings[v]
            log(f"{case} {v}: " + " | ".join(
                f"event {r['event_ms']:.6f} ms, device {r['device_ms']:.6f} "
                f"ms ({r['device_by']}, {r['launches']:g} launches), host "
                f"{r['host_us']:.2f} us, cold "
                f"{r['cold_ms']:.6f} ms" for r in rs))
        log(f"{case}: {shapes[case]}; bound {row['bound_ms']:.6f} ms over "
            f"{nbytes} bytes")
    host_work = [(t, r.cpu().numpy(), v.cpu().numpy()) for t, r, v in flush]
    result["flush_host_us"] = {"pageable": [], "staged": []}
    for staged in (False, True, True, False):
        us = flush_host_us(host_work, staged)
        result["flush_host_us"]["staged" if staged else "pageable"].append(us)
    log("flush host µs (row 8's tables, median of 50): " + json.dumps(
        result["flush_host_us"]))
    if not all(torch.equal(s, s0) for (s, _, _), s0 in zip(sources, kept)):
        raise AssertionError("a scatter wrote its source table")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    for row in result["rows"].values():
        for rs in row["readings"].values():
            for r in rs:
                r.pop("device_names", None)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
