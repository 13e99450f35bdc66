#!/usr/bin/env python3
"""Chip smoke for the torch port: the `torch://` main path on one CUDA card.

    python3 chip_smoke.py        (from the repository root; needs one card)

Drives the port's serving path at full size — the multitenant-1m
deployment (`models/workloads.py multitenant_1m()` with its defaults:
1,000,000 tuples, 200,000 pods, 50,000 users) loaded into
`create_endpoint("torch://")` — and checks it:

1. card identity (torch device name, the nvidia-smi name/power-limit line);
2. build: the CUDA kernels compiled from ops/kernels/csrc for sm_90a;
3. load: workload generation, store load, device graph build;
4. lookups: `lookup_resources_batch("pod", "view", 256 subjects)` batches;
5. checks: `check_bulk_permissions` over 10,000 (pod, subject) pairs;
   every read kernel (all but `scatter_rows`) must have launched during
   phases 4-5;
6. kernels against their plain-torch twins, on the card, on the real
   1M-row tables: every step of two real sweeps, the seed, the delta, the
   check gather and the lookup transpose, bit for bit; then one whole
   lookup batch re-run on the CPU twins (state, trace and words equal)
   and launched step by step (equal to its CUDA graph replays), and a
   warm endpoint batch that must be one graph replay and one readback a
   sweep, its launch counts those of the steps; each sweep kernel's
   launches and the whole sweep, step by step and replayed, timed by
   `attribute`;
7. answers against the host oracle on a fixed-seed sample (4 full
   lookups, 2,000 checks);
8. the sweep byte model and the bound it implies at this card's peak;
9. the write path on the same endpoint: 16 rounds of churn (64 pod
   creates on spare rows, 32 pod deletes that reclaim them, 16 hub-group
   touches and 8 deletes, 2 grants that grow a full namespace row), each
   followed by a 256-lane lookup batch and a 10,000-pair check batch that
   read the round's writes; every kernel, `scatter_rows` included, must
   have launched during the rounds (each round's first batch recaptures
   the sweep graphs, whose host cost is logged).  No rebuild may happen;
   after every flush
   the card's tables equal the host's; `scatter_rows` is held against its
   twin on one round's real dirty rows (duplicates added); a batch
   captured before a round's writes extracts its old answers after the
   flush; the post-churn answers equal those after `force_rebuild()` and
   a sample of the host oracle's;
10. the caveated deployment on a second endpoint: the reference's
   caveated RBAC-with-deny workload (`caveated_rbac()`) at the users,
   groups and pods of multitenant-1m, whose undecidable caveats put the
   graph on the tri-state (definite/maybe bitplane) path.  Its read
   batches (256-lane lookups, 10,000-pair checks) must answer CONDITIONAL
   somewhere and route nothing to the oracle; every step of a real Jacobi
   sweep, the plane seed, `check_gather3` and the definite-half lookup
   must equal their twins on the full tables, and one whole batch must
   equal the CPU twins' and its step-by-step launch (the graph checks
   and `attribute` timings of phase 6, on the Jacobi sweep); a sample of checks (CONDITIONAL ones included)
   and one lookup must equal the host oracle's; then 8 rounds of caveat
   churn (new undecidable memberships, re-touches that flip decidability,
   deletes, caveated tuples made definite) must be absorbed without a
   rebuild, leave the card's tables equal to the host's after each
   flush, and answer as `force_rebuild()` and the oracle do.  Every kernel
   of the caveat path (all but the definite `check_gather`) must have
   launched during phase 10.
11. the segment kernel on the phase-3 store, before phase 10 frees the
   ELL endpoint: `create_endpoint("torch://", kernel="segment",
   store=...)`.  Its 256-lane lookup and 10,000-pair check batches must
   answer every lane and pair as the ELL endpoint does, and every kernel
   of the segment path (`edge_or` and the seed, permission, delta, check
   and lookup kernels) must have launched in them; `edge_or` is held
   against its twin on the full edge arrays (padding edges in), one real
   sweep step by step, one whole batch on the CPU twins; then 4 rounds
   of phase 9's churn through the shared store: no rebuild, the card's
   edge arrays equal the host's after each flush, `scatter_rows`
   launched from the segment flush, both endpoints' answers equal;
12. the Leopard index at the reference's group-explosion deployment
   (`group_explosion()` defaults: 100,000 groups in depth-8 chains,
   2,000 users, 5,000 docs): an indexed endpoint (A) and an index-free
   one (B) on one store.  `doc#view` must be indexed (and nothing at
   multitenant-1m, over the budget); A's read batches must be served
   from the closure plane (`check_gather` and `word_cols_T`, no sweep
   kernel) and equal B's and a sample of the oracle's; B's staged sweep
   over the chains is held against the twins step by step and against
   its step-by-step launch; the plane kernels are held against their
   twins on the full plane; then 4 rounds of the
   reference bench's tail-user moves (quarantine, background re-close),
   after which `wait_rebuilds()` leaves `doc#view` indexed and A serving
   from the plane again.

13. the mesh path: a 2 x 4 (data x graph) mesh over the visible cards
   (`cuda:0` repeated when fewer than eight are visible), each phase run
   while the deployment it reuses is alive.  (a) `TorchEndpoint(mesh=...)`
   on the phase-3 store: its 256-lane lookup and 10,000-pair check
   batches must answer as the single-device endpoint, every per-shard
   kernel must have launched in them, the all_gathers must move
   `comm_model`'s bytes per sweep, the seed and two sweeps must equal the
   twins shard by shard and a whole batch on the twins (on the card
   tensors) the kernels'; then 4 rounds of phase 9's churn: no rebuild,
   every table block of every data replica equal to the host table
   after each flush, `scatter_rows` launched by the sharded flush, answers
   equal the single-device endpoint's.  (b) `ShardedKernel` (the
   edge-sharded segment sweep) on the segment endpoint's program and
   edges: answers equal that endpoint's, `or_combine` (one launch a data
   shard, its 4 replicas) equal its twin on a real sweep's partials and
   timed beside the library chain (3 `bitwise_or_` + 3 `copy_`).  (c)
   the caveated deployment of phase 10 on a mesh endpoint: tri-state
   answers (CONDITIONAL included) equal the
   single-device endpoint's, nothing routed to the oracle, the block-form
   `cav_gather_or` launched and the sweep equal to the twins.  (d)
   group-explosion of phase 12 on a mesh endpoint with the index on:
   `doc#view` indexed in one plane block per graph shard, reads served
   from it with no sweep kernel, answers equal A's.

14. batched dispatch, BASELINE config 5, on the phase-3 endpoint wrapped
   in the port's `BatchingEndpoint` (phases 1-13 build their endpoints
   with `dispatch=direct`, the bare endpoint whose internals they read).
   (a) 256 concurrent `lookup_resources` calls, one a user, must answer
   as one direct 256-lane batch in fewer than 256 kernel calls, fused
   batches of more than one; (b) 64 concurrent `check_bulk_permissions`
   calls (10,000 pairs) interleaved with 256 concurrent lookups must
   answer as the direct endpoint; every read kernel must launch in (a)-(b)
   (counts from zero), and a fixed-seed sample equals the oracle; (e) one
   pinned side-stream readback ran for every fused batch, and its bytes
   equal a blocking copy of the same result; (c) (a) and (b) at pipeline
   depth 1 and 2 and through the direct endpoint, 5 runs each: median
   wall, per-request p50/p99 and batch counts, beside the `nvidia-smi`
   line; (d) a lookup and a check batch started before a round of phase
   9's churn and finished after its flush and sweep-graph recapture keep
   their pre-write answers.

15. off-loop rebuilds (the port's ASYNC_REBUILD switch, which phases 1-14
   keep off: each asserts that its churn rebuilds nothing) on the phase-3
   store.  (a) a fresh endpoint's `warm_start(prewarm=True)`: its seconds,
   the lane buckets warmed and the captures made; its first 256-lane
   lookup and 10,000-pair check batches run no eager sweep, make no
   capture and answer as the phase-3 endpoint; (b) unique-name pods
   created at ~200 a second past the pod spare pool while a reader thread
   issues 256-lane pod#view lookup batches, switch on (one preemptive
   background rebuild, no quarantine) and off (the pool runs dry and a
   read waits out the rebuild): the reader's p50/p99/max, the lock-held
   install and the card's memory before, at its peak during and after
   the swap; (c) more new tenants in one write than the tenant pool
   holds: pod#view quarantined to the oracle (checks) while the held
   candidate waits and group#member still on the kernel, then after the
   swap no quarantine, the card's tables equal the host's, the answers
   equal `force_rebuild()`'s and the oracle's; (d) launches from zero
   over one background swap whose candidate is prewarmed and replays
   writes at its install: every read kernel and `scatter_rows`.  The
   mesh endpoint of 13a and the caveated endpoint of 10 each take one
   background swap, after which their answers equal the single-device
   endpoint's and the oracle's.
16. the proxy's read path (`proxy/server.py` `ProxyServer`) over
   `torch://` at multitenant-1m, on its own endpoint built from the
   phase-3 workload and warm-started with the prewarm, in front of a
   fake kube-apiserver with 2,000 namespaces, 10,000 pods and 1,000
   events, with deploy/rules.yaml's read rules: 256 concurrent pod lists
   (BASELINE config 5 through the proxy), 1,000 pod gets, an events
   postfilter list, a protobuf and a Table list and the e2e tests' watch
   scenario, all through the embedded client.  Lists equal the seeded
   pods intersected with the endpoint's lookup (8 users: the oracle's),
   gets the oracle's checks; no read goes to the oracle; every read
   kernel launches for these requests, which rebuild nothing.  Logged:
   the lists' per-request p50/p99/max and wall, the proxy's own time
   (request less upstream), the upstream round trip, the prefilter and
   the largest wait on it, beside a direct 256-lane batch; the gets'
   p50/p99, the launches, the card's memory; with h11 installed also one
   list over a loopback socket.

Wherever `lookup_T` and `scatter_rows` are timed (phases 6, 9, 10, 11,
13a), their rows also carry the device-only time, the time with L2
flushed and the host cost per call, of the kernel and of its library
yardstick (`attribute`), so that a gap between the event-timed loops is
put down to the card or to the host.

Phases run in the order 1-9, 11, 13a-b, 14, 15, 10, 13c, 12, 13d, 16, and
each phase's seconds are logged.  Any failed phase raises and the script
exits non-zero.  The second-to-last line is the kernel table as JSON,
the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

SEED = 20261017
N_WARM = 5              # warm batches per verb (medians over these)
LOOKUP_LANES = 256      # concurrent list subjects per lookup batch
N_CHECKS = 10_000       # (pod, subject) pairs per check batch
ORACLE_LOOKUPS = 4
ORACLE_CHECKS = 2_000
REPS = 10               # timing repetitions per kernel measurement
ATTR_CALLS = 50         # calls per device-only / host-cost measurement
L2_FLUSH_BYTES = 256 << 20   # scratch written before each cold call (> 5 x L2)

# phase 9, the write path (per round)
N_ROUNDS = 16
ROUND_CREATES = 64      # new pods, each dual-written (namespace + creator)
ROUND_DELETES = 32      # pods created two rounds earlier, both tuples
ROUND_GROUP_TOUCHES = 16
ROUND_GROUP_DELETES = 8
ROUND_GRANTS = 2        # namespace viewer grants on one namespace
ISOLATION_ROUND = 8
CHURN_ORACLE_CHECKS = 500

# phase 10, the caveated deployment: caveated_rbac at multitenant-1m's
# users, groups and pods; the generator's own caveat mix and seed
CAVEAT_WORKLOAD = {"n_pods": 200_000, "n_users": 50_000, "n_groups": 2_000}
CAV_ROUNDS = 8
CAV_NEW = 16            # new undecidable memberships per round
CAV_RETOUCH = 8         # re-touches flipping decided <-> undecidable
CAV_DELETES = 8         # deletes of caveated tuples
CAV_DEFINITE = 4        # caveated tuples replaced by definite ones
CAV_ORACLE_CHECKS = 1_000
CAV_ORACLE_CONDITIONAL = 200
CAV_CHURN_ORACLE = 300

# phase 11, the segment kernel at multitenant-1m: churn rounds of phase
# 9's generator through the shared store
SEG_ROUNDS = 4
# phase 12, the Leopard index at group-explosion (its defaults: 100,000
# groups in depth-8 chains, 2,000 users, 5,000 docs)
LEO_ROUNDS = 4
LEO_ORACLE_LOOKUPS = 4
LEO_ORACLE_CHECKS = 500
# phase 13, the mesh path: a 2 x 4 (data x graph) mesh on every deployment
# above; churn rounds of phase 9's generator on its multitenant-1m endpoint
MESH_DATA, MESH_GRAPH = 2, 4
MESH_ROUNDS = 4
# phase 14, batched dispatch on the phase-3 endpoint: BASELINE config 5's
# 256 concurrent list requests, then mixed traffic with 64 concurrent
# check calls, each dispatch mode run DISPATCH_REPEATS times
DISPATCH_CHECK_CALLS = 64
DISPATCH_REPEATS = 5
DISPATCH_ORACLE_CHECKS = 300
DISPATCH_ORACLE_SUBJECTS = 2    # lookups held against oracle checks
DISPATCH_ORACLE_PODS = 100      # allowed, and as many refused, pods each
# phase 15, off-loop rebuilds on the phase-3 store: unique-name pods
# created past the spare pool (pool + OFFLOOP_EXTRA_PODS a run, in writes
# of one pod, OFFLOOP_WRITE_PODS of them every OFFLOOP_WRITE_GAP_S: ~200
# pods/s, so the 25 % low watermark leaves a rebuild ~4 s of headroom),
# then more new tenants in one write than the tenant pool holds
OFFLOOP_EXTRA_PODS = 400
OFFLOOP_WRITE_PODS = 8
OFFLOOP_WRITE_GAP_S = 0.04
OFFLOOP_EXTRA_TENANTS = 16
OFFLOOP_ORACLE_CHECKS = 100
OFFLOOP_SWAP_ORACLE = 200   # oracle checks after the 13a / 10 swaps
# phase 16, the proxy's read path at multitenant-1m: the fake
# kube-apiserver's seeded objects, the traffic, and deploy/rules.yaml's
# read rules as mappings (proxyrule.parse_doc needs no yaml, which the
# card machine may lack; a CPU test holds them equal to the file's)
PROXY_NAMESPACES = 2_000
PROXY_PODS = 10_000         # the north star's 10k-pod list
PROXY_EVENTS = 1_000
PROXY_LIST_USERS = 256      # BASELINE config 5, through the proxy
PROXY_GETS = 1_000
PROXY_ORACLE_USERS = 8
_RULE = {"apiVersion": "authzed.com/v1alpha1", "kind": "ProxyRule"}
PROXY_READ_RULES = [
    {**_RULE, "metadata": {"name": "namespace-read"},
     "match": [{"apiVersion": "v1", "resource": "namespaces",
                "verbs": ["get"]}],
     "check": [{"tpl": "namespace:{{name}}#view@user:{{user.name}}"}]},
    {**_RULE, "metadata": {"name": "namespace-enumerate"},
     "match": [{"apiVersion": "v1", "resource": "namespaces",
                "verbs": ["list", "watch"]}],
     "prefilter": [{"fromObjectIDNameExpr": "{{resourceId}}",
                    "lookupMatchingResources": {
                        "tpl": "namespace:$#view@user:{{user.name}}"}}]},
    {**_RULE, "metadata": {"name": "pod-read"},
     "match": [{"apiVersion": "v1", "resource": "pods", "verbs": ["get"]}],
     "check": [{"tpl": "pod:{{namespacedName}}#view@user:{{user.name}}"}]},
    {**_RULE, "metadata": {"name": "pod-enumerate"},
     "match": [{"apiVersion": "v1", "resource": "pods",
                "verbs": ["list", "watch"]}],
     "prefilter": [{"fromObjectIDNamespaceExpr":
                    "{{split_namespace(resourceId)}}",
                    "fromObjectIDNameExpr": "{{split_name(resourceId)}}",
                    "lookupMatchingResources": {
                        "tpl": "pod:$#view@user:{{user.name}}"}}]},
    {**_RULE, "metadata": {"name": "event-postfilter"},
     "match": [{"apiVersion": "v1", "resource": "events",
                "verbs": ["list"]}],
     "postfilter": [{"checkPermissionTemplate": {
         "tpl": "namespace:{{namespace}}#view@user:{{user.name}}"}}]},
]
UNDECIDED = '[caveat:within_quota:{"used": 1}]'
DECIDED = ('[caveat:within_quota:{"used": 1, "quota": 5}]',
           '[caveat:within_quota:{"used": 9, "quota": 5}]')

KERNEL_SOURCE = "spicedb_kubeapi_proxy_tpu_torch/ops/kernels/csrc/ell_kernels.cu"
REPLACES = {
    "ell_gather_or": "spicedb_kubeapi_proxy_tpu/ops/ell.py:444",
    "perm_program": "spicedb_kubeapi_proxy_tpu/ops/ell.py:215",
    "sweep_delta": "spicedb_kubeapi_proxy_tpu/ops/ell.py:613",
    "seed_bitplanes": "spicedb_kubeapi_proxy_tpu/ops/ell.py:556",
    "check_gather": "spicedb_kubeapi_proxy_tpu/ops/ell.py:878",
    "lookup_T": "spicedb_kubeapi_proxy_tpu/ops/ell.py:889",
    "scatter_rows": "spicedb_kubeapi_proxy_tpu/ops/jax_endpoint.py:1004",
    "cav_gather_or": "spicedb_kubeapi_proxy_tpu/ops/ell.py:528",
    "check_gather3": "spicedb_kubeapi_proxy_tpu/ops/ell.py:853",
    "edge_or": "spicedb_kubeapi_proxy_tpu/ops/spmv.py:130",
    "word_cols_T": "spicedb_kubeapi_proxy_tpu/ops/jax_endpoint.py:2970",
    "or_combine": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:69",
    "mesh_gather_or": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:482",
    "mesh_cav_gather_or": "spicedb_kubeapi_proxy_tpu/parallel/"
                          "sharding.py:503",
    "mesh_perm_program": "spicedb_kubeapi_proxy_tpu/parallel/"
                         "sharding.py:522",
    "mesh_sweep_delta": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:529",
}
# further TPU kernels a ported kernel also stands for (PERF.md rows 9-11)
REPLACES_ALSO = {
    "edge_or": "spicedb_kubeapi_proxy_tpu/ops/spmv.py:195 (fixpoint), "
               ":155 (init_state), :320 (_pipe_fns)",
    "check_gather": "spicedb_kubeapi_proxy_tpu/ops/jax_endpoint.py:2345 "
                    "(_leo_check_fill, the Leopard check route)",
    "scatter_rows": "spicedb_kubeapi_proxy_tpu/ops/jax_endpoint.py:690 "
                    "(_SegmentGraph.flush), spicedb_kubeapi_proxy_tpu/"
                    "parallel/sharding.py:396 (_scatter_rows, per table "
                    "block)",
    "mesh_gather_or": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:491 "
                      "(the main gather) and the tiled all_gathers after "
                      "each pass (:488, :496), between replicas on one "
                      "device",
    "mesh_cav_gather_or": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:"
                          "506 (the maybe words' all_gather)",
    "mesh_sweep_delta": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:542 "
                        "(changed, pmax) and :545 (delta, psum over data)",
}
REPLACES_ALSO["edge_or"] += (", spicedb_kubeapi_proxy_tpu/parallel/"
                             "sharding.py:63 (make_sharded_evaluate, each "
                             "edge shard)")
# the kernels of the definite read path (phases 4-5) and of the caveat
# path (phase 10: definite checks are check_gather3's there)
READ_KERNELS = ("ell_gather_or", "perm_program", "sweep_delta",
                "seed_bitplanes", "check_gather", "lookup_T")
CAVEAT_KERNELS = tuple(k for k in REPLACES
                       if k not in ("check_gather", "edge_or",
                                    "word_cols_T", "or_combine")
                       and not k.startswith("mesh_"))
# the kernels of the mesh read path (phase 13a; the sharded sweep's own
# are MESH_SWEEP_KERNELS, plus mesh_cav_gather_or with planes)
MESH_SWEEP_KERNELS = ("mesh_gather_or", "mesh_perm_program",
                      "mesh_sweep_delta")
MESH_KERNELS = MESH_SWEEP_KERNELS + ("seed_bitplanes", "check_gather",
                                     "lookup_T")
POISON = 0x5A5A5A5A     # what a sweep's output buffers hold before it
# the segment path's kernels (phase 11; the init step is a plain copy of
# the seed when the program has no wildcard term, as multitenant-1m's)
SEGMENT_KERNELS = ("seed_bitplanes", "edge_or", "perm_program",
                   "sweep_delta", "check_gather", "lookup_T")
# 32-bit integer ALU rate used for the operations bound: one op per CUDA
# core lane per clock, i.e. half the 67 TFLOP/s fp32 FMA rate of an H100
# SXM at its 700 W limit (bitwise ops never reach the tensor cores)
INT_OPS_PER_S = 33.5e12


def hbm_peak(name: str) -> float:
    """Published device-memory bandwidth (bytes/s) for a card name."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name:
        return 3.35e12
    raise RuntimeError(f"no published memory bandwidth known for {name!r}")


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Device time of a callable: CUDA events around `reps` runs (warmed
    up once) on a CUDA device; host clock after a sync elsewhere."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def ms(self, fn, reps: int = REPS) -> float:
        fn()
        self.sync()
        if self.cuda:
            ev0 = self.torch.cuda.Event(enable_timing=True)
            ev1 = self.torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(reps):
                fn()
            ev1.record()
            ev1.synchronize()
            return ev0.elapsed_time(ev1) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps


def _profile(fn, n: int, before=None) -> dict:
    """{name: [launches, microseconds]} of the device activity (kernels,
    copies, memsets) of `n` calls of `fn`, each after `before()` if
    given, as torch.profiler's CUDA activity records it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU or getattr(
                e, "is_user_annotation", False):
            continue
        acc = out.setdefault(e.name, [0, 0.0])
        acc[0] += 1
        acc[1] += e.time_range.elapsed_us()
    return out


def _graph_ms(fn, n: int, before=None) -> float:
    """Device ms per call of `n` calls of `fn` (each after `before()` if
    given): CUDA events around one replay of a CUDA graph that captured
    them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(n):
            if before is not None:
                before()
            fn()
    graph.replay()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    graph.replay()
    ev1.record()
    ev1.synchronize()
    del graph
    return ev0.elapsed_time(ev1) / n


def _events_ms(fn, n: int, before=None) -> float:
    """Device ms per call of `n` back-to-back calls of `fn` (each after
    `before()` if given, which is timed alone and taken off): CUDA events
    around the loop.  For a call that is itself a CUDA graph replay, whose
    host cost per call is far below its device time."""
    import torch
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for f, sign in ((fn, 1), (None, -1)) if before is not None else \
            ((fn, 1),):
        torch.cuda.synchronize()
        ev0.record()
        for _ in range(n):
            if before is not None:
                before()
            if f is not None:
                f()
        ev1.record()
        ev1.synchronize()
        total += sign * ev0.elapsed_time(ev1)
    return total / n


def attribute(fn, n: int = ATTR_CALLS, capturable: bool = True) -> dict:
    """One callable's time on the card, four ways, so that device time
    and per-call host cost are reported apart:

    event_ms   (a) CUDA events around REPS back-to-back calls (Timer.ms);
    device_ms  (b) device time per call of its kernels, copies and
               memsets over `n` back-to-back calls;
    host_us    (c) wall time of `n` calls with no synchronise, per call;
    cold_ms    (d) device time per call when each call follows a write of
               L2_FLUSH_BYTES of scratch (the 50 MB L2 flushed; the
               write itself not counted).

    (b) and (d) come from torch.profiler's CUDA activity (device_by
    "profiler"; it records the ctypes launches too) when its record is
    whole: every activity seen `n` times or a multiple of it, the same
    in both runs (in (d) the activities (b) did not see are the scratch
    write).  Otherwise (device_by "graph") from CUDA events around the
    replay of a CUDA graph of the `n` calls, (d) less a graph of the `n`
    scratch writes alone; a call that replays a graph itself
    (`capturable` False) is timed by CUDA events around the calls
    instead (device_by "events").  `launches` is the profiler's
    activities per call.
    """
    import torch

    timer = Timer(torch, torch.device("cuda"))
    out = {"event_ms": timer.ms(fn)}
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                          device="cuda")
    flush = lambda: scratch.fill_(1)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    warm = _profile(fn, n)
    cold = {k: v for k, v in _profile(fn, n, flush).items() if k in warm}
    counts = {k: c for k, (c, _) in warm.items()}
    launches = sum(counts.values()) / n
    if counts and all(c % n == 0 for c in counts.values()) and counts == {
            k: c for k, (c, _) in cold.items()}:
        out.update(device_by="profiler",
                   device_ms=sum(t for _, t in warm.values()) / n / 1e3,
                   cold_ms=sum(t for _, t in cold.values()) / n / 1e3)
    elif capturable:
        out.update(device_by="graph", device_ms=_graph_ms(fn, n),
                   cold_ms=_graph_ms(fn, n, flush) - _graph_ms(flush, n))
    else:
        out.update(device_by="events", device_ms=_events_ms(fn, n),
                   cold_ms=_events_ms(fn, n, flush))
    out.update(launches=launches, device_names=sorted(warm))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    out["host_us"] = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    del scratch
    return out


def _twin_sweeps(kc, tables, x0, live, n_words: int, label: str) -> tuple:
    """Two sweeps of a batch from its seed `x0`: every step on the card
    and on the twins from identical copies, compared after each step,
    then the deltas.  Returns ({kernel: max error}, the steps, the state
    after the two sweeps)."""
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllKernelCache
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    dead = kc.prog.dead_index
    steps = list(kc.sweep_steps(*tables, n_words=n_words))
    err = {"ell_gather_or": 0, "perm_program": 0, "sweep_delta": 0}
    x = x0.clone()
    for sweep in range(2):
        cur_k, cur_t = x.clone(), x.clone()
        for i, step in enumerate(steps):
            EllKernelCache.run_step(step, cur_k, x0, live, kernels, x_in=x)
            EllKernelCache.run_step(step, cur_t, x0, live, reference, x_in=x)
            e = _diff(cur_k, cur_t)
            err[step[0]] = max(err.get(step[0], 0), e)
            if e:
                raise AssertionError(f"{label}: {step[0]} differs from its "
                                     f"twin at step {i} of sweep {sweep}")
        d_k = kernels.sweep_delta(cur_k, x, dead)
        d_t = reference.sweep_delta(cur_t, x, dead)
        err["sweep_delta"] = max(err["sweep_delta"], _diff(d_k.cpu(), d_t)
                                 + _diff(cur_k, cur_t))
        x = cur_k
    return err, steps, x


def sweep_split(kc, tables, x0, live, x, steps, n_words: int,
                label: str) -> dict:
    """`attribute` of one sweep's launches on the state `x` (the input of
    the batch's third sweep): each gather/program kernel's launches of
    the sweep together, the sweep's input copy and delta, and the whole
    sweep launched step by step ("eager") and replayed from a CUDA graph
    ("graph"), as `EllKernelCache.evaluate` runs it."""
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllKernelCache, _Arena
    cur = x.clone()
    dead = kc.prog.dead_index
    arena = _Arena(x0=x0, a=x, b=cur, live=live)
    out = {}
    for kind in dict.fromkeys(s[0] for s in steps):
        mine = [s for s in steps if s[0] == kind]
        out[kind] = attribute(lambda mine=mine: [EllKernelCache.run_step(
            s, cur, x0, live, kernels, x_in=x) for s in mine])
        out[kind]["calls"] = len(mine)
    out["copy"] = attribute(lambda: cur.copy_(x))
    out["sweep_delta"] = attribute(lambda: kernels.sweep_delta(cur, x, dead))
    eager = lambda: kc._sweep(x, cur, arena, tables, n_words, kc.plan)
    out["eager"] = attribute(eager)
    graph = kernels.LaunchGraph(x.device)
    graph.capture(eager)
    out["graph"] = attribute(graph.replay, capturable=False)
    del graph
    torch.cuda.synchronize()
    for k, r in out.items():
        log(f"{label} {k}: event {r['event_ms']:.6f} ms, device "
            f"{r['device_ms']:.6f} ms ({r['device_by']}, {r['launches']:g} "
            f"activities), host {r['host_us']:.2f} us, cold "
            f"{r['cold_ms']:.6f} ms")
    return out


def _split_into(rows: dict, split: dict) -> None:
    """Fold `sweep_split` readings into the kernel rows: each kernel's
    device, cold and host time per sweep, and (under ell_gather_or) the
    whole sweep's, eager and replayed."""
    pick = lambda r: {"device_ms": r["device_ms"], "cold_ms": r["cold_ms"],
                      "host_us": r["host_us"], "event_ms": r["event_ms"],
                      "device_by": r["device_by"],
                      "launches_per_call": r["launches"]}
    for kind, r in split.items():
        if kind in rows:
            rows[kind].update(pick(r))
    rows["ell_gather_or"]["sweep"] = {k: pick(split[k]) for k in
                                      ("eager", "graph", "copy")}


def split_times(kernel_fn, library_fn) -> dict:
    """The device-only, cold and host columns (`attribute` (b)-(d)) of a
    kernel and of its library yardstick, as extra fields of a kernel row
    (PERF.md rows 4c, 8, 11, 13)."""
    k = attribute(kernel_fn)
    lib = attribute(library_fn)
    return {"device_ms": k["device_ms"], "cold_ms": k["cold_ms"],
            "host_us": k["host_us"], "device_by": k["device_by"],
            "launches_per_call": k["launches"],
            "library_device_by": lib["device_by"],
            "library_device_ms": lib["device_ms"],
            "library_cold_ms": lib["cold_ms"],
            "library_host_us": lib["host_us"]}


def _log_split(label: str, t: dict) -> None:
    log(f"{label}: device {t['device_ms']:.6f} ms ({t['device_by']}, "
        f"{t['launches_per_call']:g} launches a call), cold "
        f"{t['cold_ms']:.6f} ms, host {t['host_us']:.2f} us a call; library "
        f"device {t['library_device_ms']:.6f} ms, cold "
        f"{t['library_cold_ms']:.6f} ms, host {t['library_host_us']:.2f} us")


def direct_url(device: str) -> str:
    """The `torch://` URL of phases 1-13: the bare endpoint
    (`dispatch=direct`), whose graph, stats and kernels those phases read
    and write directly, as they did before batched dispatch became the
    default; phase 14 wraps one in the dispatcher itself."""
    if device == "cuda":
        return "torch://?dispatch=direct"
    return f"torch://?device={device}&dispatch=direct"


def load(device: str, workload_kwargs: dict, generator: str = "multitenant_1m"):
    """Phase 3 (and 10): generate, load and build; returns (endpoint,
    workload)."""
    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    t0 = time.perf_counter()
    w = getattr(workloads, generator)(**workload_kwargs)
    text = "\n".join(w.relationships)
    t1 = time.perf_counter()
    url = direct_url(device)
    ep = create_endpoint(url, Bootstrap(w.schema_text, text))
    t2 = time.perf_counter()
    g = ep.graph()
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    prog = g.prog
    log(f"load: {len(w.relationships)} tuples generated in {t1 - t0:.3f} s; "
        f"store load {t2 - t1:.3f} s; graph build {t3 - t2:.3f} s")
    log(f"graph: {prog.state_size} state rows, {len(prog.edge_src)} edges, "
        f"{g.dev_aux.shape[0]} aux rows, tree depth "
        f"{g.kernel.aux_passes - 1}, {len(g.kernel.stages)} stages "
        f"({'Jacobi step' if not g.kernel.stages else 'staged'}), "
        f"{len(prog.perm_ops)} permission ops, "
        f"{len(prog.object_ids['pod'])} pod rows")
    return ep, w


def drive(ep, w, timer):
    """Phases 4-5: the main path, through the endpoint's public verbs.
    Returns (lookup batches, their results, check requests, check results,
    per-verb timing/trace summaries)."""
    import numpy as np

    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)
    rng = np.random.default_rng(SEED)
    users = w.subjects
    batches = [[SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
               for _ in range(1 + N_WARM)]
    pods = [p for p in ep.graph().prog.object_ids["pod"] if "\x00" not in p]
    pick = rng.choice(len(pods), N_CHECKS, replace=False)
    subj = rng.integers(0, LOOKUP_LANES, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("pod", pods[i]), "view", batches[0][s])
            for i, s in zip(pick, subj)]
    summary = {}
    lookups, checks = [], []
    for verb in ("lookup", "check"):
        e2e, sweeps = [], []
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            if verb == "lookup":
                res = asyncio.run(ep.lookup_resources_batch(
                    "pod", "view", batches[k]))
                lookups.append(res)
            else:
                res = asyncio.run(ep.check_bulk_permissions(reqs))
                checks.append(res)
            timer.sync()
            e2e.append(time.perf_counter() - t0)
            sweeps.append(int(ep.graph().last_trace[0]))
        summary[verb] = {"e2e_s": e2e, "sweeps": sweeps,
                         "trace": ep.graph().last_trace[: 1 + sweeps[-1]]
                         .tolist()}
        log(f"{verb}: sweeps per batch {sweeps}; trace {summary[verb]['trace']}"
            f"; e2e per batch cold {e2e[0]:.4f} s, warm median "
            f"{statistics.median(e2e[1:]):.4f} s (all: "
            f"{', '.join(f'{t:.4f}' for t in e2e)})")
    n_allowed = sum(len(r) for r in lookups[0])
    log(f"lookup: batch 0 allowed {n_allowed} (subject, pod) pairs; "
        f"check: {sum(r.allowed for r in checks[0])} of {len(reqs)} allowed")
    return batches, lookups, reqs, checks, summary


def _diff(a, b) -> int:
    """max |a - b| over two int32 tensors (0 when bit-identical)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def kernels_vs_twins(ep, batches, reqs, timer, peak):
    """Phase 6: every kernel against its twin on the real tables, with
    its time, its twin's time and its bound.  Returns {name: row}."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllKernelCache
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        _unify_check_buckets)

    g = ep.graph()
    kc, prog = g.kernel, g.prog
    main, aux, _ = g.snapshot()
    dev = main.device
    q_arr, cols, _ = ep._encode_subjects(g, batches[0])
    q = torch.from_numpy(q_arr).to(dev)
    n_words = len(q_arr) // 32
    nt = prog.state_size + kc.n_aux_rows
    dead = prog.dead_index
    word = 4 * n_words
    rows = {}

    def row(name, err, ms, plain_ms, nbytes, ops, library_ms=None):
        b_bytes = nbytes / peak * 1e3
        b_ops = ops / INT_OPS_PER_S * 1e3
        rows[name] = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                      "replaces": REPLACES[name], "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(b_bytes, b_ops),
                      "bound_by": "bytes" if b_bytes >= b_ops
                      else "operations",
                      "library_ms": library_ms}

    # seed (one launch per batch)
    wc, live = kc._wc_ranges, None
    if wc is not None:
        live = torch.empty((wc.shape[0], n_words), dtype=torch.int32,
                           device=dev)
    x0 = kernels.seed_bitplanes(q, nt, n_words, dead, wc_ranges=wc, live=live)
    live_t = None if live is None else torch.empty_like(live)
    x0_t = reference.seed_bitplanes(q, nt, n_words, dead, wc_ranges=wc,
                                    live=live_t)
    err = _diff(x0, x0_t) + (0 if live is None else _diff(live, live_t))
    row("seed_bitplanes", err,
        timer.ms(lambda: kernels.seed_bitplanes(q, nt, n_words, dead,
                                                out=x0, wc_ranges=wc,
                                                live=live)),
        timer.ms(lambda: reference.seed_bitplanes(q, nt, n_words, dead,
                                                  wc_ranges=wc, live=live_t)),
        q.numel() * 4 + nt * word, q.numel())

    # two real sweeps, step by step: the kernel and the twin run every
    # step on identical copies, compared after each step
    err, steps, x = _twin_sweeps(kc, (main, aux, None), x0, live, n_words,
                                 "staged sweep")
    # per-sweep work of each sweep kernel, timed step by step on the
    # state after two sweeps; bytes: each input read once (distinct
    # gathered rows), each output written once
    per = {"ell_gather_or": [0.0, 0.0, 0, 0], "perm_program": [0.0, 0.0, 0, 0]}
    cur = x.clone()
    for step in steps:
        name = step[0]
        acc = per[name]
        acc[0] += timer.ms(lambda: EllKernelCache.run_step(
            step, cur, x0, live, kernels))
        acc[1] += timer.ms(lambda: EllKernelCache.run_step(
            step, cur, x0, live, reference), reps=2)
        if name == "ell_gather_or":
            idx, seeded, wcb = step[1], step[3], step[4]
            n, k = idx.shape
            uniq = int(torch.unique(idx).numel())
            acc[2] += (n * k * 4 + uniq * word + n * word * (1 + seeded)
                       + (n * 4 + word * live.shape[0] if wcb is not None
                          else 0))
            acc[3] += n * n_words * (k + seeded)
        else:
            code, length = step[1], step[3]
            n_read = int((code[0::2] == 0).sum())
            acc[2] += code.numel() * 4 + length * word * (n_read + 2)
            acc[3] += length * n_words * (code.numel() // 2 + 1)
    for name, (ms, plain, nbytes, ops) in per.items():
        row(name, err[name], ms, plain, nbytes, ops)
    x_prev = x.clone()
    row("sweep_delta", err["sweep_delta"],
        timer.ms(lambda: kernels.sweep_delta(cur, x_prev, dead)),
        timer.ms(lambda: reference.sweep_delta(cur, x_prev, dead), reps=2),
        2 * nt * word + 8, 3 * nt * n_words)
    if timer.cuda:
        # device-only, cold and host time of each kernel's launches of a
        # sweep, and of the whole sweep step by step and replayed
        _split_into(rows, sweep_split(kc, (main, aux, None), x0, live, x,
                                      steps, n_words, "staged sweep"))
        sweep_bound = (sum(per[k][2] for k in per) + 4 * nt * word + 8)
        rows["ell_gather_or"]["sweep"]["bound_ms"] = sweep_bound / peak * 1e3

    # the converged state of this batch, from the endpoint's own entry
    x_final, _ = kc.evaluate(q, n_words, main, aux, kc.take_arena(n_words))
    gidx, gcol = [], []
    qa, cmap, _ = ep._encode_subjects(g, [r.subject for r in reqs])
    for r in reqs:
        gidx.append(prog.state_index("pod", "view", r.resource.id))
        gcol.append(cmap[r.subject])
    _, gi, gc = _unify_check_buckets(qa, gidx, gcol)
    gi, gc = torch.from_numpy(gi).to(dev), torch.from_numpy(gc).to(dev)
    out_k = kernels.check_gather(x_final, gi, gc)
    out_t = reference.check_gather(x_final, gi, gc)
    pairs = int(torch.unique(gi.long() * n_words + gc.long() // 32).numel())
    row("check_gather", _diff(out_k, out_t),
        timer.ms(lambda: kernels.check_gather(x_final, gi, gc)),
        timer.ms(lambda: reference.check_gather(x_final, gi, gc)),
        gi.numel() * 4 * 3 + pairs * 4, 3 * gi.numel())
    off, length = prog.slot_range("pod", "view")
    lk = kernels.lookup_T(x_final, off, length)
    lt = reference.lookup_T(x_final, off, length)
    row("lookup_T", _diff(lk, lt),
        timer.ms(lambda: kernels.lookup_T(x_final, off, length)),
        timer.ms(lambda: reference.lookup_T(x_final, off, length)),
        2 * length * word, 0,
        library_ms=timer.ms(
            lambda: x_final.narrow(0, off, length).t().contiguous()))
    if timer.cuda:
        rows["lookup_T"].update(split_times(
            lambda: kernels.lookup_T(x_final, off, length),
            lambda: x_final.narrow(0, off, length).t().contiguous()))
        _log_split(f"lookup_T [{n_words}, {length}]", rows["lookup_T"])
    bad = {n: r["max_abs_err"] for n, r in rows.items() if r["max_abs_err"]}
    if bad:
        raise AssertionError(f"kernels disagree with their twins: {bad}")
    log("kernels vs twins on the full tables: all bit-identical "
        f"({len(steps)} sweep steps x 2 sweeps, seed, delta, "
        f"{gi.numel()} check gathers, [{n_words}, {length}] lookup words)")

    # one whole lookup batch again on the CPU twins: final state, trace
    # and lookup words equal the card's
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    kc_cpu = EllKernelCache(prog, n_aux_rows=kc.n_aux_rows,
                            tree_depth=kc.tree_depth, device=cpu,
                            shared_tree_depth=kc.aux_passes - 1,
                            stages=kc.stages)
    if kc_cpu.num_iters != kc.num_iters:
        raise AssertionError("CPU twin cache has another iteration cap")
    x_dev, tr_dev = kc.evaluate(q, n_words, main, aux,
                                kc.take_arena(n_words))
    x_cpu, tr_cpu = kc_cpu.evaluate(q.cpu(), n_words, main.cpu(), aux.cpu(),
                                    kc_cpu.take_arena(n_words))
    if not (torch.equal(x_dev.cpu(), x_cpu)
            and np.array_equal(tr_dev, tr_cpu)):
        raise AssertionError("card and CPU-twin sweeps disagree")
    log(f"whole batch on the CPU twins: state and trace {tr_cpu[:1 + tr_cpu[0]]}"
        f" equal the card's ({time.perf_counter() - t0:.1f} s)")
    if timer.cuda:
        graph_batch_checks(ep, kc, q, n_words, (main, aux, None), x_dev,
                           tr_dev, steps, batches[1], "pod", "staged")
    return rows, per, nt


def graph_batch_checks(ep, kc, q, n_words: int, tables, x_dev, tr_dev,
                       steps, batch, rtype: str, label: str) -> None:
    """The graph-replayed batch (`x_dev`, `tr_dev`) equals the same batch
    launched step by step; then a warm batch of the endpoint's (its arena
    already captured) is one graph replay and one readback a sweep: no
    capture, no sweep launched step by step, and the launches its replays
    count equal the steps' own."""
    import asyncio
    from collections import Counter

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    x_e, tr_e = kc._evaluate_eager(q, n_words, tables[0], tables[1],
                                   kc.take_arena(n_words), tables[2])
    if not (torch.equal(x_dev, x_e) and np.array_equal(tr_dev, tr_e)):
        raise AssertionError(f"{label}: graph-replayed and step-by-step "
                             "sweeps disagree")
    # the first batch may capture (the arenas above left the pool)
    asyncio.run(ep.lookup_resources_batch(rtype, "view", batch))
    st0 = dict(kc.graph_stats)
    kernels.reset_launches()
    asyncio.run(ep.lookup_resources_batch(rtype, "view", batch))
    sweeps = int(ep.graph().last_trace[0])
    d = {k: kc.graph_stats[k] - st0[k] for k in ("captures", "replays",
                                                   "eager_sweeps")}
    want = Counter()
    for _ in range(sweeps):
        want.update(s[0] for s in steps)
        want["sweep_delta"] += 1
    want.update(("seed_bitplanes", "lookup_T"))
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if d["captures"] or d["eager_sweeps"] or d["replays"] != sweeps or \
            got != dict(want):
        raise AssertionError(f"{label}: a warm batch was not one replay a "
                             f"sweep: graph stats {d}, launches {got}, "
                             f"want {dict(want)}")
    log(f"{label}: graph-replayed batch equals the step-by-step one (state, "
        f"trace {tr_dev[:1 + tr_dev[0]].tolist()}); a warm endpoint batch of "
        f"{sweeps} sweeps = {sweeps} graph replays + {sweeps} readbacks, "
        f"launches {got}; graph stats {kc.graph_stats}")


def oracle_check(ep, batches, lookups, reqs, checks):
    """Phase 7: sampled answers against the host Evaluator."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    oracle = ep._oracle
    t0 = time.perf_counter()
    for i in rng.choice(LOOKUP_LANES, ORACLE_LOOKUPS, replace=False):
        want = sorted(oracle.lookup_resources("pod", "view", batches[0][i]))
        got = sorted(lookups[0][i])
        if got != want:
            raise AssertionError(f"lookup for {batches[0][i]} differs from "
                                 f"the oracle ({len(got)} vs {len(want)})")
    t1 = time.perf_counter()
    for i in rng.choice(len(reqs), ORACLE_CHECKS, replace=False):
        r = reqs[i]
        if oracle.check(r.resource, r.permission, r.subject) != \
                checks[0][i].allowed:
            raise AssertionError(f"check {r} differs from the oracle")
    log(f"oracle: {ORACLE_LOOKUPS} full lookups ({t1 - t0:.1f} s) and "
        f"{ORACLE_CHECKS} checks ({time.perf_counter() - t1:.1f} s) equal")


def _churn_plan(w, n_rounds: int, seed: int, tag: str = "w") -> list:
    """Phase 9's writes, from the seed: per round a list of writes, each
    a list of (op, relationship string) — one pod create or delete per
    write (the proxy's dual-write commits its two tuples together), one
    write per group or namespace tuple.  Also returns per round the new
    pods with their creators and the granted (namespace, user) pairs."""
    import random
    rng = random.Random(seed)
    users = w.subjects
    members: dict = {}
    one_viewer: list = []
    n_ns = 0
    for r in w.relationships:
        if r.startswith("group:") and "#member@user:" in r:
            g, u = r[len("group:"):].split("#member@user:")
            members.setdefault(g, []).append(u)
        elif r.startswith("namespace:") and "#viewer@" in r:
            one_viewer.append(r[len("namespace:"):].split("#", 1)[0])
        elif r.startswith("namespace:") and "#tenant@" in r:
            n_ns += 1
    # hub groups: the largest member lists (every one an OR-tree root)
    hubs = sorted(members, key=lambda g: (-len(members[g]), g))[:64]
    live_members = [(g, u) for g in hubs for u in members[g]]
    rng.shuffle(live_members)
    grant_ns = sorted(set(one_viewer))
    rng.shuffle(grant_ns)
    plan = []
    for r in range(n_rounds):
        writes, created, granted = [], [], []
        for i in range(ROUND_CREATES):
            k, u = rng.randrange(n_ns), rng.choice(users)
            pod = f"ns{k}/{tag}{r}-{i}"
            created.append((pod, k, u))
            writes.append([("touch", f"pod:{pod}#namespace@namespace:ns{k}"),
                           ("touch", f"pod:{pod}#creator@user:{u}")])
        if r >= 2:
            for pod, k, u in plan[r - 2]["created"][:ROUND_DELETES]:
                writes.append([
                    ("delete", f"pod:{pod}#namespace@namespace:ns{k}"),
                    ("delete", f"pod:{pod}#creator@user:{u}")])
        for _ in range(ROUND_GROUP_TOUCHES):
            writes.append([("touch", f"group:{rng.choice(hubs)}#member@user:"
                                     f"{rng.choice(users)}")])
        for _ in range(ROUND_GROUP_DELETES):
            g, u = live_members.pop()
            writes.append([("delete", f"group:{g}#member@user:{u}")])
        ns = grant_ns[r]
        for _ in range(ROUND_GRANTS):
            u = rng.choice(users)
            granted.append((ns, u))
            writes.append([("touch", f"namespace:{ns}#viewer@user:{u}")])
        rng.shuffle(writes)
        plan.append({"writes": writes, "created": created,
                     "granted": granted})
    return plan


def _tables_match(graph):
    """The card's gather tables equal the host's (after a flush)."""
    import torch
    for dev, host in zip(graph.snapshot(),
                         (graph.host_main, graph.host_aux, graph.host_cav)):
        if (dev is None) != (host is None) or (
                dev is not None
                and not torch.equal(dev.cpu(), torch.from_numpy(host))):
            raise AssertionError("device tables differ from the host tables "
                                 "after the flush")


def churn(ep, w, timer, peak, warm_lookup_s, n_rounds: int = N_ROUNDS):
    """Phase 9: the write path.  Returns the scatter_rows kernel row."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)

    t_phase = time.perf_counter()
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    plan = _churn_plan(w, n_rounds, SEED + 9)
    rng = np.random.default_rng(SEED + 9)
    users = w.subjects
    g = ep.graph()
    pods = [p for p in g.prog.object_ids["pod"] if "\x00" not in p]
    pods_in: dict = {}
    for p in pods:
        pods_in.setdefault(p.split("/", 1)[0], []).append(p)
    stats0 = dict(ep.stats)

    async def commit(writes):
        for wr in writes:
            await ep.write_relationships(
                [RelationshipUpdate(ops[o], parse_relationship(r))
                 for o, r in wr])

    def lookup(subjects):
        t0 = time.perf_counter()
        res = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        timer.sync()
        return res, time.perf_counter() - t0

    tables_match = _tables_match

    touched = []            # (pod, user) pairs the churn touched
    rounds = []
    subjects_of = []
    kernels.reset_launches()
    for r, rnd in enumerate(plan):
        creators = list(dict.fromkeys(u for _, _, u in rnd["created"]))
        extra = [users[i] for i in rng.choice(len(users), LOOKUP_LANES,
                                              replace=False)]
        names = list(dict.fromkeys(creators + extra))[:LOOKUP_LANES]
        subjects = [SubjectRef("user", u) for u in names]
        subjects_of.append(subjects)
        iso = None
        if r == ISOLATION_ROUND:
            # a batch over the subjects whose pods this round deletes,
            # captured before the writes and extracted after the flush
            iso_subj = subjects_of[r - 2]
            before, _ = lookup(iso_subj)
            ctx = ep._lookup_batch_capture("pod", "view", iso_subj)
            snap = ep.graph().snapshot()[:2]
            iso = (iso_subj, before, ctx, snap, [t.clone() for t in snap])
        if r == n_rounds - 1:
            prev_tables = ep.graph().snapshot()[:2]
            prev_host = (ep.graph().host_main.copy(),
                         ep.graph().host_aux.copy())
        a0, f0 = ep.stats["delta_apply_s"], ep.stats["flush_s"]
        gs0 = dict(ep._graph.kernel.graph_stats)
        t0 = time.perf_counter()
        asyncio.run(commit(rnd["writes"]))
        t_write = time.perf_counter() - t0
        res, t_lookup = lookup(subjects)
        graph = ep.graph()
        tables_match(graph)
        apply_ms = (ep.stats["delta_apply_s"] - a0) * 1e3
        flush_ms = (ep.stats["flush_s"] - f0) * 1e3
        gs = graph.kernel.graph_stats
        capture_ms = (gs["capture_s"] - gs0["capture_s"]) * 1e3
        captures = gs["captures"] - gs0["captures"]
        # the round's new pods are visible to their creators at once
        by_user = dict(zip(names, res))
        for pod, _, u in rnd["created"]:
            if pod not in set(by_user[u]):
                raise AssertionError(f"new pod {pod} missing from {u}'s "
                                     f"lookup right after the write")
        new = [(pod, u) for pod, _, u in rnd["created"]]
        pick = rng.choice(len(pods), N_CHECKS - len(new), replace=False)
        pairs = new + [(pods[i], names[j]) for i, j in
                       zip(pick, rng.integers(0, len(names), len(pick)))]
        reqs = [CheckRequest(ObjectRef("pod", p), "view",
                             SubjectRef("user", u)) for p, u in pairs]
        t0 = time.perf_counter()
        checks = asyncio.run(ep.check_bulk_permissions(reqs))
        timer.sync()
        t_check = time.perf_counter() - t0
        if not all(c.allowed for c in checks[: len(new)]):
            raise AssertionError("a creator cannot view the pod just created")
        touched += new + [(p, u) for ns, u in rnd["granted"]
                          for p in pods_in[ns][:4]]
        rounds.append({"write_ms": t_write * 1e3, "apply_ms": apply_ms,
                       "flush_ms": flush_ms, "lookup_s": t_lookup,
                       "check_s": t_check, "capture_ms": capture_ms,
                       "sweeps": int(graph.last_trace[0])})
        log(f"churn round {r}: {sum(len(x) for x in rnd['writes'])} updates "
            f"in {len(rnd['writes'])} writes {t_write * 1e3:.3f} ms; delta "
            f"application {apply_ms:.3f} ms, flush {flush_ms:.3f} ms (host); "
            f"read-after-write lookup batch {t_lookup:.4f} s, check batch "
            f"{t_check:.4f} s ({captures} sweep graph captures, "
            f"{capture_ms:.3f} ms of host); device tables equal host")
        if iso is not None:
            iso_subj, before, ctx, snap, snap0 = iso
            after = ep._lookup_batch_extract(ctx)
            if [sorted(x) for x in after] != [sorted(x) for x in before]:
                raise AssertionError("a batch captured before the writes "
                                     "changed its answers after the flush")
            if not all(torch.equal(a, b) for a, b in zip(snap, snap0)):
                raise AssertionError("the flush wrote a captured table")
            now, _ = lookup(iso_subj)
            changed = sum(sorted(a) != sorted(b) for a, b in zip(now, before))
            if not changed:
                raise AssertionError("isolation round: the writes changed "
                                     "no captured answer")
            log(f"snapshot isolation: a batch captured before round {r}'s "
                f"writes extracted its old answers after the flush ({changed}"
                f" of {len(iso_subj)} subjects' answers have since changed); "
                "the captured tables are unchanged")
    launches = dict(kernels.LAUNCHES)
    log(f"launches over the churn: {launches}")
    idle = [k for k in READ_KERNELS + ("scatter_rows",) if not launches[k]]
    if idle:
        raise AssertionError(f"kernels never launched in phase 9: {idle}")
    d = {k: ep.stats[k] - stats0[k] for k in
         ("rebuilds", "spare_assignments", "spare_reclaims", "delta_batches",
          "stage_aux_flips", "stale_pair_marks")}
    graph = ep.graph()
    grown = len(graph._grow_extra)
    log(f"churn stats: {d}; rows grown {grown}; spare aux rows left "
        f"{len(graph._spare_aux)}")
    if d["rebuilds"] or not (d["spare_assignments"] and d["spare_reclaims"]
                             and (grown or d["stage_aux_flips"])):
        raise AssertionError(f"the churn was not absorbed incrementally: {d}")
    med = lambda k: statistics.median(x[k] for x in rounds)
    log(f"write path summary: median per round delta application "
        f"{med('apply_ms'):.3f} ms, flush {med('flush_ms'):.3f} ms (host), "
        f"sweep graph captures {med('capture_ms'):.3f} ms; read-after-write "
        f"lookup batch median {med('lookup_s'):.4f} s vs phase-4 warm median "
        f"{warm_lookup_s:.4f} s ({med('lookup_s') / warm_lookup_s:.3f}x; "
        f"limit 1.10x); check batch median {med('check_s'):.4f} s")

    # scatter_rows on the last round's real rows, against its twin, and
    # its times: main and aux table per flush
    last_lookup = [sorted(x) for x in res]
    last_checks = [c.allowed for c in checks]
    out_row = {"name": "scatter_rows", "route": "cuda",
               "source": KERNEL_SOURCE, "replaces": REPLACES["scatter_rows"],
               "launches": launches["scatter_rows"]}
    err, ms, plain, lib, nbytes, dims, work = 0, 0.0, 0.0, 0.0, 0, [], []
    for src, host_prev, host in zip(prev_tables, prev_host,
                                    (graph.host_main, graph.host_aux)):
        changed = np.nonzero((host != host_prev).any(axis=1))[0]
        if not len(changed):
            continue
        dev = src.device
        rows_np = changed.astype(np.int32)
        dup = np.concatenate([rows_np, rows_np[: max(1, len(rows_np) // 2)],
                              np.repeat(rows_np[-1:], 5)])
        t_rows = torch.from_numpy(dup).to(dev)
        t_vals = torch.from_numpy(host[dup]).to(dev)
        got = kernels.scatter_rows(src, t_rows, t_vals)
        want = reference.scatter_rows(src, t_rows, t_vals)
        live = graph.dev_main if host is graph.host_main else graph.dev_aux
        err = max(err, _diff(got, want), _diff(got, live))
        rows_t = torch.from_numpy(rows_np).to(dev)
        vals_t = torch.from_numpy(host[rows_np]).to(dev)
        rows64 = rows_t.long()
        ms += timer.ms(lambda: kernels.scatter_rows(src, rows_t, vals_t))
        plain += timer.ms(lambda: reference.scatter_rows(src, rows_t, vals_t))
        lib += timer.ms(lambda: torch.index_put(src, (rows64,), vals_t))
        work.append((src, rows_t, vals_t))
        r_, k_ = src.shape
        nbytes += 2 * r_ * k_ * 4 + len(rows_np) * (k_ + 1) * 4
        dims.append(f"[{r_}, {k_}] with {len(rows_np)} rows")
    if err:
        raise AssertionError(f"scatter_rows differs from its twin: {err}")
    log(f"scatter_rows vs twin on the last round's rows ({'; '.join(dims)}, "
        f"duplicates added): bit-identical; one flush {ms:.6f} ms, twin "
        f"{plain:.6f} ms, torch.index_put {lib:.6f} ms, bound "
        f"{nbytes / peak * 1e3:.6f} ms")
    out_row.update(max_abs_err=err, ms=ms, plain_ms=plain,
                   bound_ms=nbytes / peak * 1e3, bound_by="bytes",
                   library_ms=lib)
    if timer.cuda:
        # the flush (every touched table), then the main table alone
        out_row.update(split_times(
            lambda: [kernels.scatter_rows(*a) for a in work],
            lambda: [torch.index_put(t, (r.long(),), v) for t, r, v in work]))
        _log_split("scatter_rows, one flush", out_row)
        main = split_times(
            lambda: kernels.scatter_rows(*work[0]),
            lambda: torch.index_put(work[0][0], (work[0][1].long(),),
                                    work[0][2]))
        _log_split(f"scatter_rows, {dims[0]}", main)
        out_row.update({f"first_table_{k}": v for k, v in main.items()})

    # the incremental generation answers as a fresh build does
    t0 = time.perf_counter()
    ep.force_rebuild()
    timer.sync()
    t_rebuild = time.perf_counter() - t0
    res2, _ = lookup(subjects_of[-1])
    checks2 = asyncio.run(ep.check_bulk_permissions(reqs))
    if [sorted(x) for x in res2] != last_lookup or \
            [c.allowed for c in checks2] != last_checks:
        raise AssertionError("post-churn answers differ from force_rebuild()")
    log(f"force_rebuild() {t_rebuild:.3f} s (the per-write cost without "
        f"delta absorption); answers equal; check-batch sweeps "
        f"incremental {rounds[-1]['sweeps']}, rebuilt "
        f"{int(ep.graph().last_trace[0])}")

    # the host oracle on touched pairs and one creator's lookup
    oracle = ep._oracle
    t0 = time.perf_counter()
    sample = [touched[i] for i in rng.choice(len(touched),
                                             CHURN_ORACLE_CHECKS,
                                             replace=False)]
    got = asyncio.run(ep.check_bulk_permissions(
        [CheckRequest(ObjectRef("pod", p), "view", SubjectRef("user", u))
         for p, u in sample]))
    for (p, u), c in zip(sample, got):
        if oracle.check(ObjectRef("pod", p), "view",
                        SubjectRef("user", u)) != c.allowed:
            raise AssertionError(f"check pod:{p} user:{u} differs from the "
                                 "oracle")
    t1 = time.perf_counter()
    creator = SubjectRef("user", plan[-1]["created"][0][2])
    want = sorted(oracle.lookup_resources("pod", "view", creator))
    if sorted(res2[subjects_of[-1].index(creator)]) != want:
        raise AssertionError(f"lookup for {creator} differs from the oracle")
    log(f"oracle: {CHURN_ORACLE_CHECKS} touched-pair checks "
        f"({t1 - t0:.1f} s) and 1 creator lookup "
        f"({time.perf_counter() - t1:.1f} s) equal")
    log(f"phase 9 wall time {time.perf_counter() - t_phase:.1f} s")
    return out_row


def _cav_index(w):
    """From the caveated workload's tuples: user -> groups, group -> pods
    it is assigned to, and the caveated tuples (as written)."""
    member_of: dict = {}
    assigned: dict = {}
    caveated: list = []
    for r in w.relationships:
        if "[caveat:" in r:
            caveated.append(r)
        if r.startswith("group:") and "#member@user:" in r:
            g, u = r[len("group:"):].split("#member@user:")
            member_of.setdefault(u.split("[", 1)[0], []).append(g)
        elif "#assigned@group:" in r:
            p, g = r[len("pod:"):].split("#assigned@group:")
            assigned.setdefault(g.split("#", 1)[0], []).append(p)
    return member_of, assigned, caveated


def _cav_pairs(rng, users, pods, member_of, assigned, n):
    """`n` (pod, user) check pairs over `users`: half of them pods
    assigned to one of the user's groups (where HAS and CONDITIONAL
    live), half random pods."""
    out = []
    for k in range(n):
        u = users[int(rng.integers(len(users)))]
        groups = [g for g in member_of.get(u, ()) if g in assigned]
        if k % 2 == 0 and groups:
            g = groups[int(rng.integers(len(groups)))]
            out.append((assigned[g][int(rng.integers(len(assigned[g])))], u))
        else:
            out.append((pods[int(rng.integers(len(pods)))], u))
    return out


def _tri(results) -> list:
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import Permissionship
    code = {Permissionship.NO_PERMISSION: 0,
            Permissionship.CONDITIONAL_PERMISSION: 1,
            Permissionship.HAS_PERMISSION: 2}
    return [code[r.permissionship] for r in results]


def _cav_churn_plan(graph, caveated, member_of, assigned, users, seed):
    """Phase 10's writes, from the seed: per round (op, relationship) pairs
    and the (pod, user) pairs they touch.  Every caveated tuple is touched
    at most once; an undecidable insert goes only where its destination
    row of the caveat table still has a free slot (so the churn never
    needs a rebuild to grow a caveat tree)."""
    import random
    rng = random.Random(seed)
    prog = graph.prog
    dead = prog.dead_index
    free: dict = {}

    def take_slot(dst) -> bool:
        if dst not in free:
            free[dst] = int((graph.host_cav[dst] == dead).sum())
        if free[dst] <= 0:
            return False
        free[dst] -= 1
        return True

    def dst_of(rel: str):
        res, rest = rel.split("#", 1)
        t, rid = res.split(":", 1)
        return prog.state_index(t, rest.split("@", 1)[0], rid)

    def pairs_of(rel: str) -> list:
        res, rest = rel.split("#", 1)
        u = rest.split("@user:", 1)[1].split("[", 1)[0]
        if res.startswith("pod:"):
            return [(res[len("pod:"):], u)]
        return [(p, u) for p in assigned.get(res[len("group:"):], ())[:4]]

    pool = list(caveated)
    rng.shuffle(pool)
    groups = sorted(assigned)
    rng.shuffle(groups)
    plan = []
    for _ in range(CAV_ROUNDS):
        writes = []
        for _ in range(CAV_NEW):
            while True:
                g, u = groups.pop(), rng.choice(users)
                rel = f"group:{g}#member@user:{u}"
                if g not in member_of.get(u, ()) and take_slot(dst_of(rel)):
                    break
            writes.append(("touch", rel + UNDECIDED))
        flips = 0
        while flips < CAV_RETOUCH:
            rel = pool.pop()
            key, cav = rel.split("[caveat:", 1)
            if cav.startswith(UNDECIDED[len("[caveat:"):]):
                writes.append(("touch", key + DECIDED[flips % 2]))
            elif take_slot(dst_of(key)):
                writes.append(("touch", key + UNDECIDED))
            else:
                continue
            flips += 1
        for _ in range(CAV_DELETES):
            writes.append(("delete", pool.pop()))
        for _ in range(CAV_DEFINITE):
            writes.append(("touch", pool.pop().split("[caveat:", 1)[0]))
        rng.shuffle(writes)
        plan.append({"writes": writes,
                     "touched": [pr for _, rel in writes
                                 for pr in pairs_of(rel)]})
    return plan


def caveats(timer, peak, smi_line, device: str = "cuda",
            workload_kwargs: Optional[dict] = None) -> tuple:
    """Phase 10: the caveated deployment on a second endpoint.  Returns
    ({kernel name: measurements on the caveat path}, the endpoint, its
    workload, {"warm_lookup_s", "rounds"} of the write path)."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllKernelCache
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        _sweep_bytes, _unify_check_buckets)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)

    t_phase = time.perf_counter()
    ep, w = load(device, workload_kwargs or CAVEAT_WORKLOAD, "caveated_rbac")
    g = ep.graph()
    prog, kc = g.prog, g.kernel
    if not (g.has_cav and g.tri_state_capable and kc.planes):
        raise AssertionError("the caveated deployment compiled no planes")
    log(f"caveat planes: {len(prog.cav_src)} undecidable caveat edges; "
        f"tables main {list(g.dev_main.shape)}, aux {list(g.dev_aux.shape)} "
        f"({g.dev_aux.shape[0] - g._cav_aux_base + prog.state_size} caveat "
        f"OR-tree rows), caveat {list(g.dev_cav.shape)}; aux passes "
        f"{kc.aux_passes}, iteration cap {kc.num_iters}")
    member_of, assigned, caveated = _cav_index(w)
    users = w.subjects
    pods = [p for p in prog.object_ids["pod"] if "\x00" not in p]
    rng = np.random.default_rng(SEED + 10)
    batches = [[SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
               for _ in range(1 + N_WARM)]
    lanes0 = [s.id for s in batches[0]]
    pairs = _cav_pairs(rng, lanes0, pods, member_of, assigned, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("pod", p), "view", SubjectRef("user", u))
            for p, u in pairs]
    res0 = ep.stats["oracle_residual_checks"]

    # the main path of this slice, launches counted from zero
    kernels.reset_launches()
    summary, lookups, checks = {}, [], []
    for verb in ("lookup", "check"):
        e2e, sweeps = [], []
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            if verb == "lookup":
                lookups.append(asyncio.run(ep.lookup_resources_batch(
                    "pod", "view", batches[k])))
            else:
                checks.append(asyncio.run(ep.check_bulk_permissions(reqs)))
            timer.sync()
            e2e.append(time.perf_counter() - t0)
            sweeps.append(int(g.last_trace[0]))
        summary[verb] = {"e2e_s": e2e, "sweeps": sweeps}
        log(f"caveats {verb}: sweeps per batch {sweeps}; trace "
            f"{g.last_trace[: 1 + sweeps[-1]].tolist()}; e2e per batch cold "
            f"{e2e[0]:.4f} s, warm median {statistics.median(e2e[1:]):.4f} s "
            f"(all: {', '.join(f'{t:.4f}' for t in e2e)})")
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    log(f"launches on the caveat path: {launches}")
    # the warm lookup batches again, split at the endpoint's two phases
    split = []
    for k in range(1, 1 + N_WARM):
        t0 = time.perf_counter()
        ctx = ep._lookup_batch_capture("pod", "view", batches[k])
        timer.sync()
        t1 = time.perf_counter()
        ep._lookup_batch_extract(ctx)
        split.append((t1 - t0, time.perf_counter() - t1))
    log(f"caveats lookup split over {N_WARM} warm batches: capture (encode, "
        f"sweeps, kernels) median "
        f"{statistics.median(a for a, _ in split):.4f} s, extract "
        f"(readback, per-subject column scan, id lists) median "
        f"{statistics.median(b for _, b in split):.4f} s")
    tri0 = _tri(checks[0])
    counts = {v: tri0.count(v) for v in (2, 1, 0)}
    log(f"caveats: check batch HAS {counts[2]}, CONDITIONAL {counts[1]}, NO "
        f"{counts[0]} of {len(reqs)}; lookup batch 0 allowed "
        f"{sum(len(r) for r in lookups[0])} (subject, pod) pairs")
    if not counts[1]:
        raise AssertionError("no CONDITIONAL answer: the MAYBE plane never "
                             "answered")
    if any(_tri(c) != tri0 for c in checks[1:]):
        raise AssertionError("repeated check batches disagree")
    if ep.stats["oracle_residual_checks"] != res0 or any(
            r.source != "kernel" for c in checks for r in c):
        raise AssertionError("caveat rows were routed to the oracle")

    # every kernel of a real Jacobi sweep against its twin, on the card,
    # on the full tables; then one whole batch on the CPU twins
    main, aux, cav = g.snapshot()
    dev = main.device
    q_arr, cmap, _ = ep._encode_subjects(g, batches[0])
    q = torch.from_numpy(q_arr).to(dev)
    n_words = len(q_arr) // 32
    width = kc.width(n_words)
    nt = prog.state_size + kc.n_aux_rows
    dead = prog.dead_index
    word = 4 * width
    rows = {}

    def row(name, err, ms, plain_ms, nbytes, ops, library_ms=None):
        b_bytes = nbytes / peak * 1e3
        b_ops = ops / INT_OPS_PER_S * 1e3
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(b_bytes, b_ops),
                      "bound_by": "bytes" if b_bytes >= b_ops
                      else "operations", "library_ms": library_ms}

    wc, live = kc._wc_ranges, None
    if wc is not None:
        live = torch.empty((wc.shape[0], width), dtype=torch.int32,
                           device=dev)
    x0 = kernels.seed_bitplanes(q, nt, n_words, dead, wc_ranges=wc,
                                live=live, planes=True)
    x0_t = reference.seed_bitplanes(q, nt, n_words, dead, wc_ranges=wc,
                                    live=None if live is None
                                    else torch.empty_like(live), planes=True)
    row("seed_bitplanes", _diff(x0, x0_t),
        timer.ms(lambda: kernels.seed_bitplanes(q, nt, n_words, dead, out=x0,
                                                wc_ranges=wc, live=live,
                                                planes=True)),
        timer.ms(lambda: reference.seed_bitplanes(q, nt, n_words, dead,
                                                  wc_ranges=wc, live=live,
                                                  planes=True)),
        q.numel() * 4 + nt * word, 2 * q.numel())
    err, steps, x = _twin_sweeps(kc, (main, aux, cav), x0, live, n_words,
                                 "Jacobi sweep")
    # per-sweep work of each sweep kernel at this batch's shapes; bytes:
    # each input read once (distinct gathered rows), each output written
    # once; the caveat gather reads and writes only the maybe half of the
    # rows it reaches
    per = {k: [0.0, 0.0, 0, 0] for k in ("ell_gather_or", "cav_gather_or",
                                         "perm_program")}
    x_in = x.clone()
    cur = x.clone()
    for step in steps:
        name = step[0]
        acc = per[name]
        acc[0] += timer.ms(lambda: EllKernelCache.run_step(
            step, cur, x0, live, kernels, x_in=x_in))
        acc[1] += timer.ms(lambda: EllKernelCache.run_step(
            step, cur, x0, live, reference, x_in=x_in), reps=2)
        if name == "ell_gather_or":
            idx, seeded, wcb = step[1], step[3], step[4]
            n, k = idx.shape
            uniq = int(torch.unique(idx).numel())
            acc[2] += (n * k * 4 + uniq * word + n * word * (1 + seeded)
                       + (n * 4 + word * live.shape[0] if wcb is not None
                          else 0))
            acc[3] += n * width * (k + seeded)
        elif name == "cav_gather_or":
            _, idx, half, _ = step
            r_, k = idx.shape
            uniq = int(torch.unique(idx).numel())
            reached = int((idx != dead).any(dim=1).sum())
            acc[2] += r_ * k * 4 + (uniq + 2 * reached) * 4 * half
            acc[3] += r_ * half * k
        else:
            code, length = step[1], step[3]
            n_read = int((code[0::2] == 0).sum())
            acc[2] += code.numel() * 4 + length * word * (n_read + 2)
            acc[3] += length * width * (code.numel() // 2 + 1)
    for name, (ms, plain, nbytes, ops) in per.items():
        row(name, err[name], ms, plain, nbytes, ops)
    x_prev = x.clone()
    row("sweep_delta", err["sweep_delta"],
        timer.ms(lambda: kernels.sweep_delta(cur, x_prev, dead)),
        timer.ms(lambda: reference.sweep_delta(cur, x_prev, dead), reps=2),
        2 * nt * word + 8, 3 * nt * width)
    if timer.cuda:
        _split_into(rows, sweep_split(kc, (main, aux, cav), x0, live, x,
                                      steps, n_words, "Jacobi sweep"))
        rows["ell_gather_or"]["sweep"]["bound_ms"] = (
            sum(per[k][2] for k in per) + 4 * nt * word + 8) / peak * 1e3

    x_final, trace = kc.evaluate(q, n_words, main, aux, kc.take_arena(n_words),
                                 cav)
    qa, cm, _ = ep._encode_subjects(g, [r.subject for r in reqs])
    gidx = [prog.state_index("pod", "view", r.resource.id) for r in reqs]
    gcol = [cm[r.subject] for r in reqs]
    _, gi, gc = _unify_check_buckets(qa, gidx, gcol)
    gi, gc = torch.from_numpy(gi).to(dev), torch.from_numpy(gc).to(dev)
    out_k = kernels.check_gather3(x_final, gi, gc, n_words)
    out_t = reference.check_gather3(x_final, gi, gc, n_words)
    cells = int(torch.unique(gi.long() * n_words + gc.long() // 32).numel())
    row("check_gather3", _diff(out_k, out_t),
        timer.ms(lambda: kernels.check_gather3(x_final, gi, gc, n_words)),
        timer.ms(lambda: reference.check_gather3(x_final, gi, gc, n_words)),
        gi.numel() * 4 * 3 + cells * 4 * 2, 5 * gi.numel())
    off, length = prog.slot_range("pod", "view")
    lk = kernels.lookup_T(x_final, off, length, n_words)
    row("lookup_T", _diff(lk, reference.lookup_T(x_final, off, length,
                                                 n_words)),
        timer.ms(lambda: kernels.lookup_T(x_final, off, length, n_words)),
        timer.ms(lambda: reference.lookup_T(x_final, off, length, n_words)),
        2 * length * 4 * n_words, 0,
        library_ms=timer.ms(lambda: x_final.narrow(0, off, length)
                            [:, :n_words].t().contiguous()))
    if timer.cuda:
        rows["lookup_T"].update(split_times(
            lambda: kernels.lookup_T(x_final, off, length, n_words),
            lambda: x_final.narrow(0, off, length)[:, :n_words].t()
            .contiguous()))
        _log_split(f"lookup_T, definite plane [{n_words}, {length}]",
                   rows["lookup_T"])
    bad = {n: r["max_abs_err"] for n, r in rows.items() if r["max_abs_err"]}
    if bad:
        raise AssertionError(f"caveat-path kernels disagree with their "
                             f"twins: {bad}")
    log(f"caveat-path kernels vs twins on the full tables: all bit-identical"
        f" ({len(steps)} Jacobi steps x 2 sweeps, plane seed, delta over "
        f"{width} words, {gi.numel()} tri-state gathers, [{n_words}, "
        f"{length}] definite lookup words)")
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    kc_cpu = EllKernelCache(prog, n_aux_rows=kc.n_aux_rows,
                            tree_depth=kc.tree_depth, device=cpu,
                            shared_tree_depth=kc.aux_passes - 1, planes=True)
    if kc_cpu.num_iters != kc.num_iters:
        raise AssertionError("CPU twin cache has another iteration cap")
    x_cpu, tr_cpu = kc_cpu.evaluate(q.cpu(), n_words, main.cpu(), aux.cpu(),
                                    kc_cpu.take_arena(n_words), cav.cpu())
    if not (torch.equal(x_final.cpu(), x_cpu) and np.array_equal(trace, tr_cpu)
            and torch.equal(lk.cpu(), reference.lookup_T(x_cpu, off, length,
                                                         n_words))):
        raise AssertionError("card and CPU-twin caveat sweeps disagree")
    log(f"whole caveat batch on the CPU twins: state, trace "
        f"{tr_cpu[:1 + tr_cpu[0]].tolist()} and lookup words equal the "
        f"card's ({time.perf_counter() - t0:.1f} s)")
    if timer.cuda:
        graph_batch_checks(ep, kc, q, n_words, (main, aux, cav), x_final,
                           trace, steps, batches[1], "pod", "Jacobi")
    model = _sweep_bytes(g, LOOKUP_LANES)
    sweep_ms = (sum(per[k][0] for k in per) + rows["sweep_delta"]["ms"])
    log(f"caveat sweep byte model (reference _sweep_bytes, planes): {model} "
        f"bytes per sweep at {LOOKUP_LANES} lanes; bound "
        f"{model / peak * 1e3:.6f} ms at {peak / 1e12:.2f} TB/s ({smi_line});"
        f" measured sweep kernels {sweep_ms:.6f} ms -> "
        f"{model / peak * 1e3 / sweep_ms:.4f} of the bound (ell_gather_or "
        f"{per['ell_gather_or'][0]:.6f}, cav_gather_or "
        f"{per['cav_gather_or'][0]:.6f}, perm_program "
        f"{per['perm_program'][0]:.6f}, sweep_delta "
        f"{rows['sweep_delta']['ms']:.6f})")

    # the host oracle: checks (CONDITIONAL ones included) and one lookup
    oracle = ep._oracle
    t0 = time.perf_counter()
    cond = [i for i, v in enumerate(tri0) if v == 1]
    pick = list(rng.choice(cond, min(len(cond), CAV_ORACLE_CONDITIONAL),
                           replace=False))
    rest = [i for i in range(len(reqs)) if tri0[i] != 1]
    pick += list(rng.choice(rest, CAV_ORACLE_CHECKS - len(pick),
                            replace=False))
    for i in pick:
        r = reqs[int(i)]
        if oracle.check3(r.resource, r.permission, r.subject) != tri0[int(i)]:
            raise AssertionError(f"check {r} differs from the oracle")
    t1 = time.perf_counter()
    # a subject with pods and an undecidable ban: its CONDITIONAL pod must
    # be missing from the lookup, as from the oracle's
    maybe_banned = {r.split("@user:")[1].split("[", 1)[0] for r in caveated
                    if r.startswith("pod:") and r.endswith(UNDECIDED)}
    i = max(range(len(lanes0)), key=lambda k: (lanes0[k] in maybe_banned,
                                               len(lookups[0][k])))
    want = sorted(oracle.lookup_resources("pod", "view", batches[0][i]))
    if sorted(lookups[0][i]) != want:
        raise AssertionError(f"lookup for {batches[0][i]} differs from the "
                             f"oracle")
    log(f"caveat oracle: {len(pick)} checks ({min(len(cond), CAV_ORACLE_CONDITIONAL)}"
        f" CONDITIONAL; {t1 - t0:.1f} s) and 1 lookup of {lanes0[i]} "
        f"({'an undecidable ban, ' if lanes0[i] in maybe_banned else ''}"
        f"{len(want)} pods; {time.perf_counter() - t1:.1f} s) equal")

    # caveat churn: absorbed without a rebuild, read back at once
    plan = _cav_churn_plan(g, caveated, member_of, assigned, users,
                           SEED + 11)
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    stats0 = dict(ep.stats)
    touched: list = []
    rounds = []
    churn_launches = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    for r, rnd in enumerate(plan):
        a0, f0 = ep.stats["delta_apply_s"], ep.stats["flush_s"]
        t0 = time.perf_counter()

        async def commit():
            for o, rel in rnd["writes"]:
                await ep.write_relationships(
                    [RelationshipUpdate(ops[o], parse_relationship(rel))])
        asyncio.run(commit())
        t_write = time.perf_counter() - t0
        touched += rnd["touched"]
        names = list(dict.fromkeys(u for _, u in rnd["touched"]))
        names += [users[i] for i in rng.choice(len(users), LOOKUP_LANES,
                                               replace=False)]
        subjects = [SubjectRef("user", u)
                    for u in list(dict.fromkeys(names))[:LOOKUP_LANES]]
        kernels.reset_launches()
        gs0 = dict(kc.graph_stats)
        t0 = time.perf_counter()
        res = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        timer.sync()
        t_lookup = time.perf_counter() - t0
        lookup_capture_ms = (kc.graph_stats["capture_s"]
                             - gs0["capture_s"]) * 1e3
        # the same batch again with no write between: the batch's own cost,
        # so that lookup_s - again_s is what the round's writes added
        t0 = time.perf_counter()
        again = asyncio.run(ep.lookup_resources_batch("pod", "view",
                                                      subjects))
        timer.sync()
        t_again = time.perf_counter() - t0
        if [sorted(a) for a in again] != [sorted(a) for a in res]:
            raise AssertionError("a repeated lookup batch differs")
        _tables_match(g)
        round_pairs = touched + _cav_pairs(
            rng, [s.id for s in subjects], pods, member_of, assigned,
            N_CHECKS - len(touched))
        creqs = [CheckRequest(ObjectRef("pod", p), "view",
                              SubjectRef("user", u)) for p, u in round_pairs]
        t0 = time.perf_counter()
        cres = _tri(asyncio.run(ep.check_bulk_permissions(creqs)))
        timer.sync()
        t_check = time.perf_counter() - t0
        for k, v in kernels.LAUNCHES.items():
            churn_launches[k] += v
        for p, u in rnd["touched"][:24]:
            j = round_pairs.index((p, u))
            if oracle.check3(ObjectRef("pod", p), "view",
                             SubjectRef("user", u)) != cres[j]:
                raise AssertionError(f"read-after-write check pod:{p} "
                                     f"user:{u} differs from the oracle")
        rounds.append({"apply_ms": (ep.stats["delta_apply_s"] - a0) * 1e3,
                       "flush_ms": (ep.stats["flush_s"] - f0) * 1e3,
                       "lookup_s": t_lookup, "again_s": t_again,
                       "check_s": t_check,
                       "lookup_capture_ms": lookup_capture_ms,
                       "capture_ms": (kc.graph_stats["capture_s"]
                                      - gs0["capture_s"]) * 1e3})
        log(f"caveat churn round {r}: {len(rnd['writes'])} writes "
            f"{t_write * 1e3:.3f} ms; delta application "
            f"{rounds[-1]['apply_ms']:.3f} ms, flush "
            f"{rounds[-1]['flush_ms']:.3f} ms (host); read-after-write "
            f"lookup batch {t_lookup:.4f} s ({lookup_capture_ms:.3f} ms of "
            f"sweep graph capture; the same batch again {t_again:.4f} s), "
            f"check batch {t_check:.4f} s "
            f"(sweeps {int(g.last_trace[0])}, CONDITIONAL "
            f"{cres.count(1)}; {kc.graph_stats['captures'] - gs0['captures']}"
            f" sweep graph captures, {rounds[-1]['capture_ms']:.3f} ms of "
            f"host); device tables equal host")
    d = {k: ep.stats[k] - stats0[k] for k in
         ("rebuilds", "delta_batches", "stale_pair_marks",
          "oracle_residual_checks")}
    log(f"caveat churn stats: {d}; launches over the rounds "
        f"{churn_launches}")
    if d["rebuilds"] or d["stale_pair_marks"] or d["oracle_residual_checks"] \
            or ep.graph() is not g:
        raise AssertionError(f"the caveat churn was not absorbed "
                             f"incrementally: {d}")
    med = lambda k: statistics.median(x[k] for x in rounds)
    warm = statistics.median(summary["lookup"]["e2e_s"][1:])
    added = statistics.median(x["lookup_s"] - x["again_s"] for x in rounds)
    log(f"caveat write path summary: median per round delta application "
        f"{med('apply_ms'):.3f} ms, flush {med('flush_ms'):.3f} ms (host), "
        f"sweep graph captures {med('capture_ms'):.3f} ms "
        f"({med('lookup_capture_ms'):.3f} ms in the lookup); read-after-write "
        f"lookup batch median {med('lookup_s'):.4f} s vs warm median "
        f"{warm:.4f} s ({med('lookup_s') / warm:.3f}x; limit 1.10x); the "
        f"same batches again {med('again_s'):.4f} s "
        f"({med('again_s') / warm:.3f}x), the writes' share "
        f"{added * 1e3:.3f} ms; check batch median {med('check_s'):.4f} s")
    t0 = time.perf_counter()
    ep.force_rebuild()
    timer.sync()
    t_rebuild = time.perf_counter() - t0
    res2 = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
    cres2 = _tri(asyncio.run(ep.check_bulk_permissions(creqs)))
    if [sorted(x) for x in res2] != [sorted(x) for x in res] or cres2 != cres:
        raise AssertionError("post-churn caveat answers differ from "
                             "force_rebuild()")
    t1 = time.perf_counter()
    for j in rng.choice(len(touched), min(len(touched), CAV_CHURN_ORACLE),
                        replace=False):
        p, u = touched[int(j)]
        if oracle.check3(ObjectRef("pod", p), "view",
                         SubjectRef("user", u)) != cres[int(j)]:
            raise AssertionError(f"check pod:{p} user:{u} differs from the "
                                 "oracle after the churn")
    log(f"force_rebuild() {t_rebuild:.3f} s; post-churn answers equal; "
        f"{min(len(touched), CAV_CHURN_ORACLE)} touched-pair checks equal "
        f"the oracle ({time.perf_counter() - t1:.1f} s)")
    need = [k for k in CAVEAT_KERNELS if not (launches[k]
                                              or churn_launches[k])]
    if need:
        raise AssertionError(f"kernels never launched in phase 10: {need}")
    log(f"phase 10 wall time {time.perf_counter() - t_phase:.1f} s")
    for name, r in rows.items():
        r["launches"] = launches[name]
    return rows, ep, w, {"warm_lookup_s": warm, "rounds": rounds}


def _seg_rows(rows, name, err, ms, plain_ms, nbytes, ops, peak,
              library_ms=None):
    """A kernel-table row: bound = max(bytes over the memory rate, integer
    operations over the integer rate)."""
    b_bytes = nbytes / peak * 1e3
    b_ops = ops / INT_OPS_PER_S * 1e3
    rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": max(b_bytes, b_ops),
                  "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                  "library_ms": library_ms}


def segment_path(ep, w, timer, peak, smi_line, device: str = "cuda",
                 n_rounds: int = SEG_ROUNDS) -> dict:
    """Phase 11: the segment kernel on the phase-3 store, beside the ELL
    endpoint.  Returns {kernel name: measurements on the segment path}."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.ops.spmv import KernelCache
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        _SegmentGraph, _sweep_bytes, _unify_check_buckets)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)

    t_phase = time.perf_counter()
    url = direct_url(device)
    seg = create_endpoint(url, Bootstrap(w.schema_text, ""),
                          kernel="segment", store=ep.store)
    t0 = time.perf_counter()
    g = seg.graph()
    timer.sync()
    t_build = time.perf_counter() - t0
    if not isinstance(g, _SegmentGraph) or seg.kernel_kind != "segment":
        raise AssertionError("kernel='segment' built another graph kind")
    prog = g.prog
    cap = int(g.edge_src.shape[0])
    log(f"segment graph: {prog.state_size} state rows, {len(prog.edge_src)} "
        f"edges in a {cap}-edge capacity ({len(g.free)} free, padding "
        f"dead -> dead), {len(g.positions)} tuples positioned; build "
        f"{t_build:.3f} s (tuple-list compile, as the reference's); Leopard "
        f"statuses {seg._leopard.status_map()}")

    rng = np.random.default_rng(SEED + 11)
    users = w.subjects
    batches = [[SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
               for _ in range(1 + N_WARM)]
    pods = [p for p in prog.object_ids["pod"] if "\x00" not in p]
    pick = rng.choice(len(pods), N_CHECKS, replace=False)
    subj = rng.integers(0, LOOKUP_LANES, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("pod", pods[i]), "view", batches[0][s])
            for i, s in zip(pick, subj)]
    rebuilds0 = (seg.stats["rebuilds"], ep.stats["rebuilds"])

    # the segment path's read batches, launches counted from zero
    kernels.reset_launches()
    summary, lookups, checks = {}, [], []
    for verb in ("lookup", "check"):
        e2e, sweeps = [], []
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            if verb == "lookup":
                lookups.append(asyncio.run(seg.lookup_resources_batch(
                    "pod", "view", batches[k])))
            else:
                checks.append(asyncio.run(seg.check_bulk_permissions(reqs)))
            timer.sync()
            e2e.append(time.perf_counter() - t0)
            sweeps.append(int(g.last_trace[0]))
        summary[verb] = {"e2e_s": e2e, "sweeps": sweeps}
        log(f"segment {verb}: sweeps per batch {sweeps}; trace "
            f"{g.last_trace[: 1 + sweeps[-1]].tolist()}; e2e per batch cold "
            f"{e2e[0]:.4f} s, warm median {statistics.median(e2e[1:]):.4f} s "
            f"(all: {', '.join(f'{t:.4f}' for t in e2e)})")
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    log(f"launches on the segment path: {launches}")
    idle = [k for k in SEGMENT_KERNELS if not launches[k]]
    if idle:
        raise AssertionError(f"kernels never launched on the segment path: "
                             f"{idle}")

    # the ELL endpoint on the same batches: every lane and pair equal
    t0 = time.perf_counter()
    for k in range(1 + N_WARM):
        ell = asyncio.run(ep.lookup_resources_batch("pod", "view",
                                                    batches[k]))
        if [sorted(x) for x in ell] != [sorted(x) for x in lookups[k]]:
            raise AssertionError(f"segment lookup batch {k} differs from "
                                 "the ELL endpoint's")
    ell_checks = asyncio.run(ep.check_bulk_permissions(reqs))
    if any([c.allowed for c in ell_checks] != [c.allowed for c in cs]
           for cs in checks):
        raise AssertionError("segment checks differ from the ELL endpoint's")
    log(f"segment vs ELL: {1 + N_WARM} lookup batches x {LOOKUP_LANES} lanes "
        f"and {1 + N_WARM} check batches x {len(reqs)} pairs equal "
        f"({sum(len(x) for x in lookups[0])} allowed (subject, pod) pairs, "
        f"{sum(c.allowed for c in checks[0])} allowed checks; "
        f"{time.perf_counter() - t0:.1f} s)")

    # the kernels of one real sweep against their twins, on the full edge
    # arrays (padding edges in), step by step
    kc = g.kernel
    src, dst = g.snapshot()
    dev = src.device
    q_arr, _, _ = seg._encode_subjects(g, batches[0])
    q = torch.from_numpy(q_arr).to(dev)
    n_words = len(q_arr) // 32
    n, dead = prog.state_size, prog.dead_index
    word = 4 * n_words
    rows = {}
    x0, live = kc.init_state(q, n_words)
    x0_t = reference.seed_bitplanes(q, n, n_words, dead)
    _seg_rows(rows, "seed_bitplanes", _diff(x0, x0_t),
              timer.ms(lambda: kc.init_state(q, n_words, out=x0)),
              timer.ms(lambda: reference.seed_bitplanes(q, n, n_words, dead)),
              q.numel() * 4 + n * word, q.numel(), peak)
    steps = list(kc.sweep_steps(src, dst))
    err = {"edge_or": 0, "perm_program": 0, "sweep_delta": 0}
    x = x0.clone()
    for sweep in range(2):
        y_k = torch.empty_like(x)
        y_t = torch.empty_like(x)
        for i, step in enumerate(steps):
            kc.run_step(step, y_k, x, x0, live, kernels)
            kc.run_step(step, y_t, x, x0, live, reference)
            if step[0] in err:
                err[step[0]] = max(err[step[0]], _diff(y_k, y_t))
            if _diff(y_k, y_t):
                raise AssertionError(f"{step[0]} differs from its twin at "
                                     f"segment step {i} of sweep {sweep}")
        d_k = kernels.sweep_delta(y_k, x, dead)
        d_t = reference.sweep_delta(y_t, x, dead)
        err["sweep_delta"] = max(err["sweep_delta"], _diff(d_k.cpu(), d_t)
                                 + _diff(y_k, y_t))
        x = y_k
    # edge_or alone on the full arrays, from a zero state and from the
    # seed-initialized one, bit for bit, skipping the dead row's edges as
    # the sweep does and skipping nothing
    for base in (torch.zeros_like(x), x0):
        for skip in (dead, None):
            a, b = base.clone(), base.clone()
            kernels.edge_or(a, x, src, dst, dead=skip)
            reference.edge_or(b, x, src, dst)
            err["edge_or"] = max(err["edge_or"], _diff(a, b))
    if any(err.values()):
        raise AssertionError(f"segment kernels disagree with their twins: "
                             f"{err}")
    # per-sweep times at this batch's shapes, on the state after 2 sweeps
    y = torch.empty_like(x)
    per = {"init": [0.0, 0.0], "edge_or": [0.0, 0.0],
           "perm_program": [0.0, 0.0]}
    for step in steps:
        acc = per[step[0]]
        acc[0] += timer.ms(lambda: kc.run_step(step, y, x, x0, live,
                                               kernels))
        acc[1] += timer.ms(lambda: kc.run_step(step, y, x, x0, live,
                                               reference), reps=2)
    # edge_or's bound: the edge arrays, each distinct source row's words
    # read once and each distinct destination row's words read and
    # written once (the packed bytes the kernel must move; the
    # reference's model counts float32 lanes); one OR per edge word
    uniq_src = int(torch.unique(src).numel())
    uniq_dst = int(torch.unique(dst).numel())
    e_bytes = cap * 8 + uniq_src * word + 2 * uniq_dst * word
    # the library yardstick: the reference's float32 [N, B] layout, one
    # gather and one index_reduce_ "amax" (timed apart)
    lanes_f = 32 * n_words
    xf = ((x.view(torch.uint8).unsqueeze(-1) >> torch.arange(
        8, device=dev, dtype=torch.uint8)) & 1).reshape(n, lanes_f) \
        .to(torch.float32)
    src64, dst64 = src.long(), dst.long()
    gathered = xf[src64]
    yf = torch.zeros_like(xf)
    gather_ms = timer.ms(lambda: xf.index_select(0, src64), reps=3)
    reduce_ms = timer.ms(lambda: yf.index_reduce_(0, dst64, gathered,
                                                  "amax"), reps=3)
    del xf, gathered, yf
    _seg_rows(rows, "edge_or", err["edge_or"], per["edge_or"][0],
              per["edge_or"][1], e_bytes, cap * n_words, peak,
              library_ms=reduce_ms)
    code_ops = 0
    p_bytes = 0
    for step in steps:
        if step[0] == "perm_program":
            code, length = step[1], step[3]
            n_read = int((code[0::2] == 0).sum())
            p_bytes += code.numel() * 4 + length * word * (n_read + 2)
            code_ops += length * n_words * (code.numel() // 2 + 1)
    _seg_rows(rows, "perm_program", err["perm_program"],
              per["perm_program"][0], per["perm_program"][1], p_bytes,
              code_ops, peak)
    x_prev = x.clone()
    _seg_rows(rows, "sweep_delta", err["sweep_delta"],
              timer.ms(lambda: kernels.sweep_delta(y, x_prev, dead)),
              timer.ms(lambda: reference.sweep_delta(y, x_prev, dead),
                       reps=2),
              2 * n * word + 8, 3 * n * n_words, peak)
    sweep_ms = (per["init"][0] + per["edge_or"][0] + per["perm_program"][0]
                + rows["sweep_delta"]["ms"])
    model = _sweep_bytes(g, LOOKUP_LANES)
    log(f"segment kernels vs twins on the full edge arrays ({cap} edges, "
        f"{cap - len(prog.edge_src)} of them padding at the build): all "
        f"bit-identical ({len(steps)} steps x 2 sweeps, edge_or alone twice,"
        f" seed, delta); per sweep: init (seed copy) "
        f"{per['init'][0]:.6f} ms, edge_or {per['edge_or'][0]:.6f} ms "
        f"(bound {rows['edge_or']['bound_ms']:.6f} ms over {e_bytes} packed "
        f"bytes), perm_program {per['perm_program'][0]:.6f} ms, sweep_delta "
        f"{rows['sweep_delta']['ms']:.6f} ms; whole sweep {sweep_ms:.6f} ms. "
        f"Reference byte model (_sweep_bytes, float32 lanes): {model} bytes "
        f"-> {model / peak * 1e3:.6f} ms at {peak / 1e12:.2f} TB/s "
        f"({smi_line}). Library yardstick on the float32 [{n}, {lanes_f}] "
        f"layout: x[src] gather {gather_ms:.6f} ms, index_reduce_ amax "
        f"{reduce_ms:.6f} ms")

    # checks and lookups of the converged state, and one whole batch on
    # the CPU twins
    x_final, trace = kc.evaluate(q, n_words, src, dst,
                                 kc.take_arena(n_words))
    qa, cm, _ = seg._encode_subjects(g, [r.subject for r in reqs])
    gidx = [prog.state_index("pod", "view", r.resource.id) for r in reqs]
    gcol = [cm[r.subject] for r in reqs]
    _, gi, gc = _unify_check_buckets(qa, gidx, gcol)
    gi, gc = torch.from_numpy(gi).to(dev), torch.from_numpy(gc).to(dev)
    cells = int(torch.unique(gi.long() * n_words + gc.long() // 32).numel())
    _seg_rows(rows, "check_gather",
              _diff(kernels.check_gather(x_final, gi, gc),
                    reference.check_gather(x_final, gi, gc)),
              timer.ms(lambda: kernels.check_gather(x_final, gi, gc)),
              timer.ms(lambda: reference.check_gather(x_final, gi, gc)),
              gi.numel() * 4 * 3 + cells * 4, 3 * gi.numel(), peak)
    off, length = prog.slot_range("pod", "view")
    lk = kernels.lookup_T(x_final, off, length)
    _seg_rows(rows, "lookup_T", _diff(lk, reference.lookup_T(x_final, off,
                                                             length)),
              timer.ms(lambda: kernels.lookup_T(x_final, off, length)),
              timer.ms(lambda: reference.lookup_T(x_final, off, length)),
              2 * length * word, 0, peak,
              library_ms=timer.ms(lambda: x_final.narrow(0, off, length)
                                  .t().contiguous()))
    if timer.cuda:
        rows["lookup_T"].update(split_times(
            lambda: kernels.lookup_T(x_final, off, length),
            lambda: x_final.narrow(0, off, length).t().contiguous()))
        _log_split(f"segment lookup_T [{word // 4}, {length}]",
                   rows["lookup_T"])
    bad = {k: r["max_abs_err"] for k, r in rows.items() if r["max_abs_err"]}
    if bad:
        raise AssertionError(f"segment read kernels disagree: {bad}")
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    kc_cpu = KernelCache(prog, cpu)
    if kc_cpu.num_iters != kc.num_iters:
        raise AssertionError("CPU twin cache has another iteration cap")
    x_cpu, tr_cpu = kc_cpu.evaluate(q.cpu(), n_words, src.cpu(), dst.cpu(),
                                    kc_cpu.take_arena(n_words))
    if not (torch.equal(x_final.cpu(), x_cpu) and np.array_equal(trace, tr_cpu)
            and torch.equal(lk.cpu(), reference.lookup_T(x_cpu, off,
                                                         length))):
        raise AssertionError("card and CPU-twin segment sweeps disagree")
    log(f"whole segment batch on the CPU twins: state, trace "
        f"{tr_cpu[:1 + tr_cpu[0]].tolist()} and lookup words equal the "
        f"card's ({time.perf_counter() - t0:.1f} s)")

    # churn through the shared store: both endpoints absorb it
    plan = _churn_plan(w, n_rounds, SEED + 11, tag="s")
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    scatter = 0
    flushes = []
    for r, rnd in enumerate(plan):
        f0 = seg.stats["flush_s"]
        a0 = seg.stats["delta_apply_s"]
        if r == n_rounds - 1:
            prev_dev = g.snapshot()
            prev_host = (g.host_src.copy(), g.host_dst.copy())

        async def commit():
            for wr in rnd["writes"]:
                await seg.write_relationships(
                    [RelationshipUpdate(ops[o], parse_relationship(rel))
                     for o, rel in wr])
        asyncio.run(commit())
        creators = list(dict.fromkeys(u for _, _, u in rnd["created"]))
        extra = [users[i] for i in rng.choice(len(users), LOOKUP_LANES,
                                              replace=False)]
        names = list(dict.fromkeys(creators + extra))[:LOOKUP_LANES]
        subjects = [SubjectRef("user", u) for u in names]
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = asyncio.run(seg.lookup_resources_batch("pod", "view", subjects))
        timer.sync()
        t_lookup = time.perf_counter() - t0
        n_scatter = kernels.LAUNCHES["scatter_rows"]
        scatter += n_scatter
        if not n_scatter:
            raise AssertionError("the segment flush launched no scatter_rows")
        g2 = seg.graph()
        if g2 is not g:
            raise AssertionError("the segment endpoint rebuilt under churn")
        s_now, d_now = g.snapshot()
        if not (np.array_equal(s_now.cpu().numpy(), g.host_src)
                and np.array_equal(d_now.cpu().numpy(), g.host_dst)):
            raise AssertionError("card edge arrays differ from the host's "
                                 "after the flush")
        flushes.append((seg.stats["flush_s"] - f0) * 1e3)
        new = [(pod, u) for pod, _, u in rnd["created"]]
        pick = rng.choice(len(pods), N_CHECKS - len(new), replace=False)
        pairs = new + [(pods[i], names[j]) for i, j in
                       zip(pick, rng.integers(0, len(names), len(pick)))]
        creqs = [CheckRequest(ObjectRef("pod", p_), "view",
                              SubjectRef("user", u)) for p_, u in pairs]
        t0 = time.perf_counter()
        cres = asyncio.run(seg.check_bulk_permissions(creqs))
        timer.sync()
        t_check = time.perf_counter() - t0
        ell = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        ell_c = asyncio.run(ep.check_bulk_permissions(creqs))
        if [sorted(a) for a in res] != [sorted(b) for b in ell] or \
                [c.allowed for c in cres] != [c.allowed for c in ell_c]:
            raise AssertionError(f"segment and ELL answers differ after "
                                 f"churn round {r}")
        if not all(c.allowed for c in cres[: len(new)]):
            raise AssertionError("a creator cannot view the pod just created")
        log(f"segment churn round {r}: {sum(len(x) for x in rnd['writes'])} "
            f"updates; delta application "
            f"{(seg.stats['delta_apply_s'] - a0) * 1e3:.3f} ms, flush "
            f"{flushes[-1]:.3f} ms (host, {n_scatter} scatter_rows "
            f"launches); read-after-write lookup {t_lookup:.4f}"
            f" s, check {t_check:.4f} s (sweeps {int(g.last_trace[0])}); "
            f"{len(g.free)} free edge positions; card arrays equal host; "
            "answers equal the ELL endpoint's")
    if (seg.stats["rebuilds"], ep.stats["rebuilds"]) != rebuilds0:
        raise AssertionError("a rebuild happened during the segment churn")
    # edge_or again on the arrays the last flush produced: inserts sit in
    # free positions out of destination order
    src_c, dst_c = g.snapshot()
    descents = int((np.diff(g.host_dst.astype(np.int64)) < 0).sum())
    live_c = int((g.host_src != dead).sum())
    churn_err = 0
    for base in (torch.zeros_like(x), x0):
        a, b = base.clone(), base.clone()
        kernels.edge_or(a, x, src_c, dst_c, dead=dead)
        reference.edge_or(b, x, src_c, dst_c)
        churn_err = max(churn_err, _diff(a, b))
    if churn_err:
        raise AssertionError(f"edge_or differs from its twin on the "
                             f"churned edge arrays: {churn_err}")
    log(f"edge_or vs twin on the edge arrays after {n_rounds} churn rounds "
        f"({live_c} live edges of {cap}; {descents} positions whose "
        f"destination is below the one before it): bit-identical, "
        f"{timer.ms(lambda: kernels.edge_or(a, x, src_c, dst_c, dead=dead)):.6f}"
        f" ms a call")
    # scatter_rows at the segment flush's shapes: the last round's edge
    # positions into each [cap, 1] edge array, against its twin and
    # torch.index_put; the captured arrays are the pre-flush snapshot
    changed = np.nonzero((g.host_src != prev_host[0])
                         | (g.host_dst != prev_host[1]))[0].astype(np.int32)
    rows_t = torch.from_numpy(changed).to(dev)
    rows64 = rows_t.long()
    s_err, s_ms, s_plain, s_lib, s_work = 0, 0.0, 0.0, 0.0, []
    for old, host, live_arr in zip(prev_dev, (g.host_src, g.host_dst),
                                   g.snapshot()):
        old2 = old.view(cap, 1)
        vals = torch.from_numpy(host[changed][:, None].copy()).to(dev)
        s_work.append((old2, rows_t, vals))
        got = kernels.scatter_rows(old2, rows_t, vals)
        s_err = max(s_err, _diff(got, reference.scatter_rows(old2, rows_t,
                                                             vals)),
                    _diff(got.view(cap), live_arr))
        s_ms += timer.ms(lambda: kernels.scatter_rows(old2, rows_t, vals))
        s_plain += timer.ms(lambda: reference.scatter_rows(old2, rows_t,
                                                           vals))
        s_lib += timer.ms(lambda: torch.index_put(old2, (rows64,), vals))
    if s_err:
        raise AssertionError(f"scatter_rows differs on the edge arrays: "
                             f"{s_err}")
    s_bytes = 2 * (2 * cap * 4 + len(changed) * 2 * 4)
    log(f"scatter_rows vs twin on the last round's {len(changed)} edge "
        f"positions of both [{cap}, 1] arrays: bit-identical, equal to the "
        f"flushed arrays; one flush {s_ms:.6f} ms, twin {s_plain:.6f} ms, "
        f"torch.index_put {s_lib:.6f} ms, bound {s_bytes / peak * 1e3:.6f}"
        f" ms")
    med = lambda v: statistics.median(v[1:])
    log(f"segment summary: warm median lookup "
        f"{med(summary['lookup']['e2e_s']):.6f} s, check "
        f"{med(summary['check']['e2e_s']):.6f} s; sweeps "
        f"{summary['lookup']['sweeps'][-1]}; edge_or {per['edge_or'][0]:.6f} "
        f"ms per sweep vs bound {rows['edge_or']['bound_ms']:.6f} ms; whole "
        f"sweep {sweep_ms:.6f} ms; flush median "
        f"{statistics.median(flushes):.3f} ms host; scatter_rows launches "
        f"{scatter}")
    log(f"phase 11 wall time {time.perf_counter() - t_phase:.1f} s")
    rows["edge_or"]["max_abs_err"] = max(rows["edge_or"]["max_abs_err"],
                                         churn_err)
    for name, r in rows.items():
        r["launches"] = launches[name]
    rows["scatter_rows"] = {"launches": scatter, "max_abs_err": s_err,
                            "ms": s_ms, "plain_ms": s_plain,
                            "bound_ms": s_bytes / peak * 1e3,
                            "bound_by": "bytes", "library_ms": s_lib}
    if timer.cuda:
        rows["scatter_rows"].update(split_times(
            lambda: [kernels.scatter_rows(*a) for a in s_work],
            lambda: [torch.index_put(t, (r.long(),), v)
                     for t, r, v in s_work]))
        _log_split("segment flush scatter_rows", rows["scatter_rows"])
    return rows, summary, seg


def _leo_pairs(w, rng, n: int, depth: int = 8) -> list:
    """(doc, user) check pairs for group-explosion, as the reference
    bench draws them: half with the doc's own chain-tail user (HAS until
    a churn moves the user), half with a random user."""
    n_users = len(w.subjects)
    doc_user = {}
    for r in w.relationships:
        if r.startswith("doc:"):
            d, head = r[len("doc:"):].split("#viewer@group:g")
            doc_user[d] = f"u{(int(head.split('#')[0]) // depth) % n_users}"
    docs = sorted(doc_user)
    out = []
    for _ in range(n):
        d = docs[int(rng.integers(len(docs)))]
        u = (doc_user[d] if rng.random() < 0.5
             else f"u{int(rng.integers(n_users))}")
        out.append((d, u))
    return out, doc_user


def leopard_path(timer, peak, smi_line, mt_statuses: dict,
                 device: str = "cuda", workload_kwargs: Optional[dict] = None,
                 n_rounds: int = LEO_ROUNDS) -> dict:
    """Phase 12: the Leopard index at group-explosion's full size, an
    indexed endpoint (A) against an index-free one (B) on one store.
    Returns {kernel name: measurements on the plane reads}."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)

    t_phase = time.perf_counter()
    over = {k: v for k, v in mt_statuses.items()
            if v == "ineligible(over-budget)"}
    log(f"multitenant-1m Leopard statuses (phase 3): {mt_statuses}")
    if not over or any(v.startswith("indexed") for v in mt_statuses.values()):
        raise AssertionError("multitenant-1m should index nothing: every "
                             "eligible nested pair is over the budget")
    depth = 8
    t0 = time.perf_counter()
    w = workloads.group_explosion(**(workload_kwargs or {}))
    text = "\n".join(w.relationships)
    url = direct_url(device)
    a = create_endpoint(url, Bootstrap(w.schema_text, text))
    b = create_endpoint(url, Bootstrap(w.schema_text, ""), store=a.store,
                        leopard=False)
    t1 = time.perf_counter()
    a.graph()
    timer.sync()
    t2 = time.perf_counter()
    b.graph()
    timer.sync()
    t3 = time.perf_counter()
    lp = a._leopard
    statuses = lp.status_map()
    frag = lp.lookup_frag("doc", "view")
    if statuses.get("doc#view") != "indexed" or frag is None:
        raise AssertionError(f"doc#view is not indexed: {statuses}")
    plane = frag.plane[0]
    n_users = len(w.subjects)
    log(f"group-explosion: {len(w.relationships)} tuples, generated and "
        f"loaded in {t1 - t0:.3f} s; build A (index on) {t2 - t1:.3f} s, B "
        f"(index off) {t3 - t2:.3f} s; statuses {statuses}; doc#view plane "
        f"{list(plane.shape)} int32 = {plane.numel() * 4} bytes on "
        f"{plane.device}, host closure (state + seeds) {frag.nbytes_host} "
        f"bytes over {frag.n_rows} fragment rows x {frag.words} words; "
        f"{lp.uploads} upload(s) {lp.upload_s * 1e3:.3f} ms")

    rng = np.random.default_rng(SEED + 12)
    oracle = a._oracle
    batches = [[SubjectRef("user", w.subjects[i]) for i in
                rng.choice(n_users, LOOKUP_LANES, replace=False)]
               for _ in range(1 + N_WARM)]
    pairs, doc_user = _leo_pairs(w, rng, N_CHECKS - 400)
    # HAS pairs from oracle lookups, so both answers occur
    t0 = time.perf_counter()
    for s in batches[0][:LEO_ORACLE_LOOKUPS]:
        got = oracle.lookup_resources("doc", "view", s)
        pairs += [(d, s.id) for d in got[:100]]
    t_oracle_lookups = time.perf_counter() - t0
    pairs += [(d, f"u{int(rng.integers(n_users))}")
              for d in rng.choice(sorted(doc_user), N_CHECKS - len(pairs))]
    reqs = [CheckRequest(ObjectRef("doc", d), "view", SubjectRef("user", u))
            for d, u in pairs]

    def reads(ep, label):
        out_l, out_c, e2e = [], [], {"lookup": [], "check": []}
        sweeps = []
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            out_l.append(asyncio.run(ep.lookup_resources_batch(
                "doc", "view", batches[k])))
            timer.sync()
            e2e["lookup"].append(time.perf_counter() - t0)
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            out_c.append(asyncio.run(ep.check_bulk_permissions(reqs)))
            timer.sync()
            e2e["check"].append(time.perf_counter() - t0)
            tr = ep.graph().last_trace
            sweeps.append(int(tr[0]) if tr is not None else 0)
        log(f"{label}: lookup e2e cold {e2e['lookup'][0]:.4f} s, warm median "
            f"{statistics.median(e2e['lookup'][1:]):.6f} s; check e2e cold "
            f"{e2e['check'][0]:.4f} s, warm median "
            f"{statistics.median(e2e['check'][1:]):.6f} s; last sweeps "
            f"{sweeps}")
        return out_l, out_c, e2e, sweeps

    kernels.reset_launches()
    s0 = dict(a.stats)
    a_l, a_c, a_e2e, _ = reads(a, "A (index on)")
    a_launch = dict(kernels.LAUNCHES)
    served = {k: a.stats[k] - s0[k] for k in ("leopard_checks",
                                              "leopard_lookups",
                                              "kernel_calls")}
    log(f"A launches {a_launch}; served {served}")
    swept = [k for k in ("ell_gather_or", "perm_program", "sweep_delta",
                         "seed_bitplanes", "edge_or", "lookup_T")
             if a_launch[k]]
    if swept or served["kernel_calls"]:
        raise AssertionError(f"A's batches reached the sweep: {swept}")
    # one closure column per distinct query column of each lookup batch
    n_cols = sum(len(set(a._encode_subjects(a.graph(), bt)[1].values()))
                 for bt in batches)
    if (served["leopard_checks"] != (1 + N_WARM) * len(reqs)
            or served["leopard_lookups"] != n_cols
            or not (a_launch["check_gather"] and a_launch["word_cols_T"])):
        raise AssertionError(f"A's batches were not served from the plane: "
                             f"{served}")
    kernels.reset_launches()
    b_l, b_c, b_e2e, b_sweeps = reads(b, "B (index off)")
    if b.stats["leopard_checks"] or b.stats["leopard_lookups"]:
        raise AssertionError("B consulted an index")
    if min(b_sweeps) < 2:
        raise AssertionError(f"B did not sweep the chains: {b_sweeps}")
    for k in range(1 + N_WARM):
        if [sorted(x) for x in a_l[k]] != [sorted(x) for x in b_l[k]] or \
                [c.allowed for c in a_c[k]] != [c.allowed for c in b_c[k]]:
            raise AssertionError(f"A and B disagree on batch {k}")
    n_has = sum(c.allowed for c in a_c[0])
    if not 0 < n_has < len(reqs):
        raise AssertionError(f"the check batch is one-sided: {n_has}")
    log(f"A and B agree on {1 + N_WARM} lookup batches and {1 + N_WARM} "
        f"check batches ({n_has} HAS of {len(reqs)}, "
        f"{sum(len(x) for x in a_l[0])} allowed (user, doc) pairs); B's "
        f"trace {b.graph().last_trace[: 1 + b_sweeps[-1]].tolist()}")
    t0 = time.perf_counter()
    for i in rng.choice(len(reqs), LEO_ORACLE_CHECKS, replace=False):
        r = reqs[int(i)]
        if oracle.check(r.resource, r.permission, r.subject) != \
                a_c[0][int(i)].allowed:
            raise AssertionError(f"check {r} differs from the oracle")
    for i in range(2):
        s = batches[0][i]
        if sorted(oracle.lookup_resources("doc", "view", s)) != \
                sorted(a_l[0][i]):
            raise AssertionError(f"lookup for {s} differs from the oracle")
    log(f"oracle: {LEO_ORACLE_CHECKS} checks and 2 lookups equal A's "
        f"({time.perf_counter() - t0:.1f} s; the HAS-pair lookups took "
        f"{t_oracle_lookups:.1f} s)")

    # the plane kernels against their twins, on the full plane
    rows = {}
    if timer.cuda:
        rows.update(staged_b_vs_twins(b, batches))
    dev = plane.device
    prog = a.graph().prog
    off = prog.slot_offsets[("doc", "view")]
    q_arr, cols, _ = a._encode_subjects(a.graph(), [r.subject for r in reqs])
    pr = np.asarray([prog.state_index("doc", "view", r.resource.id) - off
                     for r in reqs], np.int32)
    pc = np.asarray([frag.col_of[int(q_arr[cols[r.subject]])]
                     for r in reqs], np.int32)
    pr_t, pc_t = torch.from_numpy(pr).to(dev), torch.from_numpy(pc).to(dev)
    cells = len(set(zip(pr.tolist(), (pc // 32).tolist())))
    _seg_rows(rows, "check_gather",
              _diff(kernels.check_gather(plane, pr_t, pc_t),
                    reference.check_gather(plane, pr_t, pc_t)),
              timer.ms(lambda: kernels.check_gather(plane, pr_t, pc_t)),
              timer.ms(lambda: reference.check_gather(plane, pr_t, pc_t)),
              len(pr) * 4 * 3 + cells * 4, 3 * len(pr), peak)
    rows_n = frag.plane_rows
    all_w = torch.arange(plane.shape[1], dtype=torch.int32, device=dev)
    batch_w = torch.tensor(sorted({int(frag.col_of[int(q_arr[c])]) // 32
                                   for c in set(cols.values())}),
                           dtype=torch.int32, device=dev)
    err = 0
    # 1 and 7 words take the column read, the batch's and all words the
    # tiled one; repeated words both
    word_sets = (all_w[:1], batch_w[:7], batch_w, all_w,
                 all_w.flip(0)[:7].repeat(2), batch_w.repeat(2))
    for words in word_sets:
        err = max(err, _diff(kernels.word_cols_T(plane, rows_n, words),
                             reference.word_cols_T(plane, rows_n, words)))
    w64 = batch_w.long()
    _seg_rows(rows, "word_cols_T", err,
              timer.ms(lambda: kernels.word_cols_T(plane, rows_n, batch_w)),
              timer.ms(lambda: reference.word_cols_T(plane, rows_n, batch_w)),
              2 * batch_w.numel() * rows_n * 4 + batch_w.numel() * 4, 0,
              peak, library_ms=timer.ms(
                  lambda: plane[:rows_n, w64].t().contiguous()))
    if any(r["max_abs_err"] for r in rows.values()):
        raise AssertionError(f"plane kernels disagree with their twins: "
                             f"{rows}")
    log(f"plane kernels vs twins on the full [{rows_n}, {plane.shape[1]}] "
        f"plane: check_gather over {len(pr)} (row, col) pairs and "
        f"word_cols_T over {[int(w_.numel()) for w_ in word_sets]} words "
        f"(1, 7, the batch's, all, repeated): bit-identical; check_gather "
        f"{rows['check_gather']['ms']:.6f} ms (bound "
        f"{rows['check_gather']['bound_ms']:.6f}), word_cols_T "
        f"{rows['word_cols_T']['ms']:.6f} ms for the batch's words (bound "
        f"{rows['word_cols_T']['bound_ms']:.6f}, library "
        f"{rows['word_cols_T']['library_ms']:.6f})")

    # churn: the reference bench's tail-user moves
    ops_of = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    # one user membership per chain, at its tail
    n_chains = sum(1 for r in w.relationships
                   if r.startswith("group:") and "@user:" in r)
    rebuilds0 = a.stats["rebuilds"]
    crng = np.random.default_rng(SEED + 13)
    q0, r0 = lp.quarantines, lp.recloses
    rounds = []
    for r in range(n_rounds):
        writes = []
        for _ in range(4):
            c = int(crng.integers(n_chains))
            tail = c * depth + depth - 1
            writes.append(("delete", f"group:g{tail}#member@user:u"
                                     f"{c % n_users}"))
            writes.append(("touch", f"group:g{tail}#member@user:u"
                                    f"{int(crng.integers(n_users))}"))
        a0, u0, us0 = (a.stats["delta_apply_s"], lp.uploads, lp.upload_s)
        a.store.write([RelationshipUpdate(ops_of[o], parse_relationship(x))
                       for o, x in writes])
        t0 = time.perf_counter()
        a.graph()                       # apply + Leopard maintenance
        t_apply = time.perf_counter() - t0
        subjects = [SubjectRef("user", x.split("@user:")[1])
                    for _, x in writes[1::2]]
        subjects += batches[r % len(batches)][: LOOKUP_LANES - len(subjects)]
        cpairs, _ = _leo_pairs(w, crng, 2_000)
        creqs = [CheckRequest(ObjectRef("doc", d), "view",
                              SubjectRef("user", u)) for d, u in cpairs]
        al = asyncio.run(a.lookup_resources_batch("doc", "view", subjects))
        ac = asyncio.run(a.check_bulk_permissions(creqs))
        bl = asyncio.run(b.lookup_resources_batch("doc", "view", subjects))
        bc = asyncio.run(b.check_bulk_permissions(creqs))
        if [sorted(x) for x in al] != [sorted(x) for x in bl] or \
                [c.allowed for c in ac] != [c.allowed for c in bc]:
            raise AssertionError(f"A and B disagree after round {r}")
        for i in crng.choice(len(creqs), 100, replace=False):
            q_ = creqs[int(i)]
            if oracle.check(q_.resource, q_.permission, q_.subject) != \
                    ac[int(i)].allowed:
                raise AssertionError(f"check {q_} differs from the oracle "
                                     f"after round {r}")
        moved = subjects[0]
        if sorted(oracle.lookup_resources("doc", "view", moved)) != \
                sorted(al[0]):
            raise AssertionError(f"lookup for {moved} differs from the "
                                 f"oracle after round {r}")
        rounds.append({"apply_ms": (a.stats["delta_apply_s"] - a0) * 1e3,
                       "call_ms": t_apply * 1e3,
                       "uploads": lp.uploads - u0,
                       "upload_ms": (lp.upload_s - us0) * 1e3})
        log(f"leopard churn round {r}: 4 deletes + 4 touches; host delta "
            f"application {rounds[-1]['apply_ms']:.3f} ms (Leopard "
            f"maintenance inside); plane uploads since the write, by "
            f"inserts and background re-closes: {rounds[-1]['uploads']} in "
            f"{rounds[-1]['upload_ms']:.3f} ms; status "
            f"{lp.status_map()['doc#view']}; quarantines "
            f"{lp.quarantines - q0}, re-closes kicked "
            f"{a.stats['leopard_recloses']}, installed {lp.recloses - r0}; "
            "A equals B and the oracle sample")
    t0 = time.perf_counter()
    if not a.wait_rebuilds(timeout=300):
        raise AssertionError("re-closes did not quiesce")
    t_wait = time.perf_counter() - t0
    if a.stats["rebuilds"] != rebuilds0 or a._leopard is not lp:
        raise AssertionError("A rebuilt under the churn")
    if lp.quarantines - q0 < 1 or lp.recloses - r0 < 1:
        raise AssertionError("the churn made no quarantine and re-close")
    frag = lp.lookup_frag("doc", "view")
    if (lp.status_map().get("doc#view") != "indexed" or frag is None
            or frag.quarantined or not frag.live):
        raise AssertionError(f"doc#view is not live again: "
                             f"{lp.status_map()}")
    # insert propagation on the live fragment: a round of touches only
    # (the bench's rounds delete first, which quarantines the fragment and
    # leaves the inserts to the re-close)
    touches = []
    for _ in range(4):
        c = int(crng.integers(n_chains))
        touches.append(f"group:g{c * depth + depth - 1}#member@user:u"
                       f"{int(crng.integers(n_users))}")
    a0, u0, us0 = a.stats["delta_apply_s"], lp.uploads, lp.upload_s
    a.store.write([RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(x))
                   for x in touches])
    a.graph()
    insert_ms = (a.stats["delta_apply_s"] - a0) * 1e3
    if lp.lookup_frag("doc", "view") is None:
        raise AssertionError("inserts quarantined the fragment")
    moved = [SubjectRef("user", x.split("@user:")[1]) for x in touches]
    al = asyncio.run(a.lookup_resources_batch("doc", "view", moved))
    bl = asyncio.run(b.lookup_resources_batch("doc", "view", moved))
    if [sorted(x) for x in al] != [sorted(x) for x in bl] or \
            sorted(oracle.lookup_resources("doc", "view", moved[0])) != \
            sorted(al[0]):
        raise AssertionError("A differs after the inserts")
    log(f"insert round (4 touches, fragment live): host delta application "
        f"{insert_ms:.3f} ms, {lp.uploads - u0} plane uploads "
        f"{(lp.upload_s - us0) * 1e3:.3f} ms; A equals B and the oracle")
    kernels.reset_launches()
    s0 = dict(a.stats)
    al = asyncio.run(a.lookup_resources_batch("doc", "view", batches[1]))
    ac = asyncio.run(a.check_bulk_permissions(reqs))
    bl = asyncio.run(b.lookup_resources_batch("doc", "view", batches[1]))
    bc = asyncio.run(b.check_bulk_permissions(reqs))
    if [sorted(x) for x in al] != [sorted(x) for x in bl] or \
            [c.allowed for c in ac] != [c.allowed for c in bc]:
        raise AssertionError("A and B disagree after the re-closes")
    if a.stats["leopard_checks"] - s0["leopard_checks"] != len(reqs) or \
            a.stats["kernel_calls"] != s0["kernel_calls"]:
        raise AssertionError("A does not serve from the plane again")
    med = lambda k: statistics.median(x[k] for x in rounds)
    log(f"after wait_rebuilds() ({t_wait:.3f} s): doc#view indexed, live; A "
        f"serves from the plane again and equals B. Leopard summary: "
        f"re-closes {lp.recloses - r0} installed in {lp.reclose_s:.3f} s "
        f"(host, background); plane uploads {lp.uploads} in total, "
        f"{lp.upload_s / max(1, lp.uploads) * 1e3:.3f} ms each; delta "
        f"application median {med('apply_ms'):.3f} ms a round; warm "
        f"medians A lookup {statistics.median(a_e2e['lookup'][1:]):.6f} s, "
        f"check {statistics.median(a_e2e['check'][1:]):.6f} s; B lookup "
        f"{statistics.median(b_e2e['lookup'][1:]):.6f} s, check "
        f"{statistics.median(b_e2e['check'][1:]):.6f} s, {b_sweeps[-1]} "
        f"sweeps")
    log(f"phase 12 wall time {time.perf_counter() - t_phase:.1f} s")
    for name, r in rows.items():
        r["launches"] = a_launch[name]
    return rows, a, w


# -- phase 13, the mesh path --------------------------------------------------

def staged_b_vs_twins(b, batches) -> dict:
    """Phase 12 (B): the index-free endpoint's staged sweep over the
    5-deep userset chains, two sweeps step by step against the twins,
    then one batch replayed from its graphs against the same batch
    launched step by step (`graph_batch_checks`).  Returns the kernels'
    errors as rows."""
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    g = b.graph()
    kc, prog = g.kernel, g.prog
    tables = g.snapshot()
    q_arr, _, _ = b._encode_subjects(g, batches[0])
    q = torch.from_numpy(q_arr).to(g.dev_main.device)
    n_words = len(q_arr) // 32
    nt = prog.state_size + kc.n_aux_rows
    live = (torch.empty((kc._wc_ranges.shape[0], n_words), dtype=torch.int32,
                        device=q.device)
            if kc._wc_ranges is not None else None)
    x0 = kernels.seed_bitplanes(q, nt, n_words, prog.dead_index,
                                wc_ranges=kc._wc_ranges, live=live)
    err, steps, _ = _twin_sweeps(kc, tables, x0, live, n_words,
                                 "group-explosion B")
    modes = [s[5] for s in steps if s[0] == "ell_gather_or"]
    log(f"group-explosion B: {len(steps)} staged steps x 2 sweeps "
        f"bit-identical to the twins (gathers in place {modes.count('in_place')}"
        f", through scratch {modes.count('scratch')})")
    x_g, tr_g = kc.evaluate(q, n_words, tables[0], tables[1],
                            kc.take_arena(n_words), plan=tables.plan)
    graph_batch_checks(b, kc, q, n_words, tables, x_g, tr_g, steps,
                       batches[1], "doc", "group-explosion B")
    return {k: {"max_abs_err": e} for k, e in err.items()
            if k in ("ell_gather_or", "perm_program")}


def make_smoke_mesh(device: str):
    """The 2 x 4 mesh of phase 13 over the visible cards, cuda:0 repeated
    when fewer than eight are visible (every shard on the CPU for a CPU
    rehearsal)."""
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import make_mesh
    n = MESH_DATA * MESH_GRAPH
    if device == "cuda":
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        devices = visible[:n] + [torch.device("cuda", 0)] * (n - len(
            visible[:n]))
    else:
        devices = [torch.device(device)] * n
    mesh = make_mesh(devices, data=MESH_DATA, graph=MESH_GRAPH)
    log(f"mesh placement: {mesh}")
    return mesh


def _mesh_endpoint(store, schema_text: str, mesh, device: str, **kw):
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    url = direct_url(device)
    return create_endpoint(url, Bootstrap(schema_text, ""), store=store,
                           mesh=mesh, **kw)


def _mesh_tables_match(graph) -> None:
    """Every block of every data replica equals the host table, remapped
    into the padded row space."""
    import numpy as np
    import torch
    want = graph.kernel.pad_tables(graph.host_main, graph.host_aux,
                                   graph.host_cav)
    for blocks, host in zip(graph.snapshot(), want):
        for d, row in enumerate(blocks):
            got = torch.cat([b.cpu() for b in row]).numpy()
            if not np.array_equal(got, host):
                raise AssertionError(f"data replica {d}'s table blocks "
                                     "differ from the host table")


def _flat(bufs) -> list:
    return [t for row in bufs for t in row]


def _uniq(t) -> int:
    import torch
    return int(torch.unique(t).numel())


def mesh_kernel_bytes(kern, tables: tuple, n_words: int) -> dict:
    """Bytes each mesh kernel must move in one sweep at these tables and
    this bucket (each input read once, each output written once), summed
    over its launches: a table block once a device, the distinct source
    rows and seed rows once a data shard a device, every replica's output
    rows once.  {kernel: bytes}."""
    main, aux = tables[0], tables[1]
    word = 4 * kern.width(n_words)
    wl = n_words // kern.mesh.shape["data"]
    out = {"mesh_gather_or": 0, "mesh_perm_program": 0,
           "mesh_sweep_delta": 0}
    if kern.planes:
        out["mesh_cav_gather_or"] = 0
    for dev, per_d in kern._placement.items():
        seen: set = set()
        for d, gs in per_d.items():
            n_rep = len(gs)
            for g in gs:
                for blk, passes in ((aux[d][g], kern.aux_passes),
                                    (main[d][g], 1)):
                    if id(blk) not in seen:
                        out["mesh_gather_or"] += passes * blk.numel() * 4
                    out["mesh_gather_or"] += passes * (
                        _uniq(blk) + blk.shape[0] * n_rep) * word
                out["mesh_gather_or"] += main[d][g].shape[0] * word   # seed
                seen.update((id(aux[d][g]), id(main[d][g])))
                if kern.planes:
                    c = tables[2][d][g]
                    if id(c) not in seen:
                        out["mesh_cav_gather_or"] += c.numel() * 4
                        seen.add(id(c))
                    reached = int((c != kern.prog.dead_index).any(
                        dim=1).sum())
                    out["mesh_cav_gather_or"] += (
                        _uniq(c) + 2 * reached * n_rep) * 4 * wl
            for code, _, length, _ in kern._plans[dev][2]:
                n_read = int((code[0::2] == 0).sum())
                out["mesh_perm_program"] += (code.numel() * 4 + length * word
                                             * (n_read + 1 + n_rep))
            out["mesh_sweep_delta"] += 2 * kern.rows * word + 8
    return out


def mesh_bound_bytes(kern, tables: tuple, n_words: int) -> dict:
    """The least bytes of one sharded sweep: {"bytes": each distinct table
    block read once a device, each data shard's input rows and seed rows
    once a device, each replica's rows written once; "old_bytes": the
    first design's count (every shard's kernels on its own replica, the
    input copies and every block copy, read and written)}."""
    main, aux = tables[0], tables[1]
    word = 4 * kern.width(n_words)
    wl = n_words // kern.mesh.shape["data"]
    n_graph = kern.mesh.shape["graph"]
    least = 0
    for dev, per_d in kern._placement.items():
        blocks = {id(t): t for d, gs in per_d.items() for g in gs
                  for t in (main[d][g], aux[d][g])
                  + ((tables[2][d][g],) if kern.planes else ())}
        least += sum(t.numel() * 4 for t in blocks.values())
        for d, gs in per_d.items():
            least += (kern.rows + kern.n_pad + len(gs) * kern.rows) * word
    old = 0
    for dev, per_d in kern._placement.items():
        for d, g in ((d, g) for d, gs in per_d.items() for g in gs):
            blk = main[d][g]
            n, k = blk.shape
            old += n * k * 4 + _uniq(blk) * word + 2 * n * word
            na, ka = aux[d][g].shape
            old += kern.aux_passes * (na * ka * 4 + _uniq(aux[d][g]) * word
                                      + na * word)
            if kern.planes:
                c = tables[2][d][g]
                nc, kc_ = c.shape
                old += nc * kc_ * 4 + _uniq(c) * 4 * wl + 2 * nc * 4 * wl
            for code, _, length, _ in kern._plans[dev][2]:
                n_read = int((code[0::2] == 0).sum())
                old += code.numel() * 4 + length * word * (n_read + 2)
            old += 2 * kern.rows * word
    per_block = ((kern.aux_passes * kern.a_pad + kern.n_pad) * word
                 + (kern.rows * 4 * wl if kern.planes else 0))
    moved = len(main) * per_block * (n_graph - 1)
    old += 2 * moved
    return {"bytes": least, "old_bytes": old, "copy_bytes": moved}


def _poisoned(kern, fn):
    """`fn()` with every sweep's output buffers (`cur` and the aux
    buffers) filled with POISON before the sweep writes them: no row may
    rely on what they held."""
    step = kern.step

    def poisoned(cur, x, x0, live, aux, *args, **kw):
        for t in _flat(cur) + _flat(aux):
            t.fill_(POISON)
        step(cur, x, x0, live, aux, *args, **kw)
    kern.step = poisoned
    try:
        return fn()
    finally:
        del kern.step


def mesh_sweep(kern, q_arr, n_words: int, tables: tuple, timer, peak,
               label: str) -> dict:
    """A sharded batch's kernels against their twins on the card: the
    seed, two sweeps call by call (every mesh_* launch and collective of
    `sweep_calls` on the kernels and on the twins from equal buffers,
    every replica and aux buffer compared after each, the output buffers
    poisoned first), the deltas; then the whole batch again on both, its
    output buffers poisoned before every sweep (state of every replica,
    trace and words equal).  Then one sweep's time, each kernel's share
    apart, and its bounds.  Returns the sweep's numbers and the mesh
    kernels' rows."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.parallel.collectives import (
        reduce_data_deltas)

    dead = kern.prog.dead_index
    n_data = kern.mesh.shape["data"]
    dev0 = kern.mesh.devices[0][0]
    ar_k = kern._alloc_arenas(n_words)
    ar_t = kern._alloc_arenas(n_words)
    x0, live = kern.seed(q_arr, n_words, ar_k)
    x0_t, live_t = kern.seed(q_arr, n_words, ar_t, reference)
    seed_err = max(_diff(a, b) for a, b in zip(_flat(x0), _flat(x0_t)))
    errs: dict = {}
    fresh = lambda bufs: [[torch.full_like(t, POISON) for t in row]
                          for row in bufs]
    zeros = lambda: {dev: torch.zeros((1, n_data, 2), dtype=torch.int32,
                                      device=dev)
                     for dev in kern._placement}
    x, x_t = x0, x0_t
    aux_bufs = [[a.aux for a in row] for row in ar_k]
    for sweep in range(2):
        cur, cur_t = fresh(x), fresh(x)
        aux_k, aux_t = fresh(aux_bufs), fresh(aux_bufs)
        calls = zip(kern.sweep_calls(cur, x, x0, live, aux_k, tables,
                                     n_words),
                    kern.sweep_calls(cur_t, x_t, x0_t, live_t, aux_t,
                                     tables, n_words))
        for (name, fk), (_, ft) in calls:
            fk(kernels)
            ft(reference)
            e = max(_diff(a, b) for a, b in zip(_flat(cur) + _flat(aux_k),
                                                _flat(cur_t) + _flat(aux_t)))
            errs[name] = max(errs.get(name, 0), e)
            if e:
                raise AssertionError(f"{label}: {name} differs from its twin "
                                     f"in sweep {sweep}")
        d_k, d_t = zeros(), zeros()
        kern.sweep_deltas(cur, x, {k: t[0] for k, t in d_k.items()})
        kern.sweep_deltas(cur_t, x_t, {k: t[0] for k, t in d_t.items()},
                          reference)
        e = max([_diff(a, b) for a, b in zip(_flat(cur), _flat(cur_t))]
                + [_diff(d_k[k], d_t[k]) for k in d_k])
        errs["mesh_sweep_delta"] = max(errs.get("mesh_sweep_delta", 0), e)
        if e:
            raise AssertionError(f"{label}: mesh_sweep_delta differs from "
                                 f"its twin in sweep {sweep}")
        x, x_t = cur, cur_t
    log(f"{label}: seed and 2 sweeps on {kern.mesh.size} shards call by "
        f"call, every replica against the twins': errors {errs}, seed "
        f"{seed_err}")
    # the whole batch, kernels and twins, on the card
    t0 = time.perf_counter()
    xs_k, tr_k = _poisoned(kern, lambda: kern.evaluate(q_arr, n_words,
                                                       tables, ar_k))
    xs_t, tr_t = _poisoned(kern, lambda: kern.evaluate(
        q_arr, n_words, tables, ar_t, reference))
    off_len = (0, min(kern.prog.state_size, 4096))
    w_k = kern.finish_lookup(xs_k, *off_len, n_words)
    w_t = kern.finish_lookup(xs_t, *off_len, n_words, reference)
    err = max([seed_err, _diff(w_k, w_t)]
              + [_diff(a, b) for a, b in zip(_flat(xs_k), _flat(xs_t))])
    if err or not np.array_equal(tr_k, tr_t):
        raise AssertionError(f"{label}: the sharded batch on the twins "
                             "differs from the kernels'")
    log(f"{label}: the whole batch on the kernels and on the twins, output "
        f"buffers poisoned before every sweep (state of every replica, "
        f"trace {tr_k[:1 + tr_k[0]].tolist()}, lookup words): "
        f"bit-identical ({time.perf_counter() - t0:.1f} s)")
    # one sweep's time on the state after two sweeps, split by kernel
    cur, aux_k = fresh(x), fresh(aux_bufs)
    d_k = zeros()
    slots_of = {k: t[0] for k, t in d_k.items()}
    calls = kern.sweep_calls(cur, x, x0, live, aux_k, tables, n_words)
    names = list(dict.fromkeys(n for n, _ in calls))
    by = {n: [f for m, f in calls if m == n] for n in names}
    slots = kern.sweep_deltas(cur, x, slots_of)

    def sweep():
        kern.step(cur, x, x0, live, aux_k, tables, n_words)
        reduce_data_deltas(d_k[dev0][0], kern.sweep_deltas(cur, x,
                                                           slots_of))
    t = {n: timer.ms(lambda fs=fs: [f(kernels) for f in fs])
         for n, fs in by.items()}
    plain = {n: timer.ms(lambda fs=fs: [f(reference) for f in fs], reps=2)
             for n, fs in by.items() if n != "all_gather_rows"}
    t["mesh_sweep_delta"] = timer.ms(lambda: kern.sweep_deltas(cur, x,
                                                               slots_of))
    plain["mesh_sweep_delta"] = timer.ms(lambda: kern.sweep_deltas(
        cur, x, slots_of, reference), reps=2)
    t["readback"] = timer.ms(lambda: reduce_data_deltas(d_k[dev0][0], slots))
    t_sweep = timer.ms(sweep)
    t_plain = timer.ms(lambda: kern.step(cur, x, x0, live, aux_k, tables,
                                         n_words, reference), reps=2)
    att = attribute(sweep, capturable=False) if timer.cuda else {}
    bound = mesh_bound_bytes(kern, tables, n_words)
    per_kernel = mesh_kernel_bytes(kern, tables, n_words)
    rows = {}
    for name, nbytes in per_kernel.items():
        b_ms = nbytes / peak * 1e3
        rows[name] = {"max_abs_err": errs.get(name, 0), "ms": t[name],
                      "plain_ms": plain[name], "bound_ms": b_ms,
                      "bound_by": "bytes", "library_ms": None}
    out = {"sweep_ms": t_sweep, "split_ms": t, "plain_step_ms": t_plain,
           "bound_ms": bound["bytes"] / peak * 1e3,
           "old_bound_ms": bound["old_bytes"] / peak * 1e3,
           "bytes": bound["bytes"], "old_bytes": bound["old_bytes"],
           "copy_bytes": bound["copy_bytes"],
           "trace": tr_k[:1 + tr_k[0]].tolist(), "max_abs_err": err,
           "attribution": {k: v for k, v in att.items()
                           if k != "device_names"},
           "device_names": att.get("device_names", []), "rows": rows}
    log(f"{label}: one sweep on {kern.mesh.size} shards: "
        + ", ".join(f"{n} {v:.6f} ms" for n, v in t.items())
        + f"; whole sweep {t_sweep:.6f} ms (event-timed); device-only "
        f"{att.get('device_ms', float('nan')):.6f} ms "
        f"({att.get('device_by')}, {att.get('launches')} activities), cold "
        f"{att.get('cold_ms', float('nan')):.6f} ms, host "
        f"{att.get('host_us', float('nan')):.2f} us; device activities "
        f"{out['device_names']}; bound {out['bound_ms']:.6f} ms over "
        f"{bound['bytes']} bytes (the first design's count "
        f"{out['old_bound_ms']:.6f} ms over {bound['old_bytes']}); the "
        f"step on the twins {t_plain:.6f} ms")
    for name, r in rows.items():
        log(f"{label}: {name} {r['ms']:.6f} ms a sweep, twins "
            f"{r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms over "
            f"{per_kernel[name]} bytes")
    return out


def _sweep_copies(kern, fn) -> tuple:
    """(fn(), the copies between two tensors on one device made through
    `Tensor.copy_` — the only way the mesh path copies state — while it
    runs, the seed's excepted: on the CPU its twin copies into the
    arena)."""
    import torch
    real, seed = torch.Tensor.copy_, kern.seed
    n, paused = [0], [False]

    def copy_(self, src, *args, **kw):
        if isinstance(src, torch.Tensor) and src.device == self.device \
                and not paused[0]:
            n[0] += 1
        return real(self, src, *args, **kw)

    def seed_(*args, **kw):
        paused[0] = True
        try:
            return seed(*args, **kw)
        finally:
            paused[0] = False
    torch.Tensor.copy_ = copy_
    kern.seed = seed_
    try:
        return fn(), n[0]
    finally:
        torch.Tensor.copy_ = real
        del kern.seed


def mesh_multitenant(ep, w, mesh, timer, peak, smi_line, device: str = "cuda",
                     n_rounds: int = MESH_ROUNDS) -> tuple:
    """Phase 13a: a 2 x 4 mesh endpoint on the phase-3 store at
    multitenant-1m.  Returns (mesh endpoint, numbers)."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        _ShardedEllGraph)
    from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import comm_model
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)

    t_phase = time.perf_counter()
    m = _mesh_endpoint(ep.store, w.schema_text, mesh, device)
    t0 = time.perf_counter()
    g = m.graph()
    timer.sync()
    t_build = time.perf_counter() - t0
    if not isinstance(g, _ShardedEllGraph):
        raise AssertionError("the mesh endpoint built no sharded graph")
    kern, prog = g.kernel, g.prog
    log(f"mesh multitenant-1m: build {t_build:.3f} s; {prog.state_size} state "
        f"rows padded to {kern.n_pad} + {kern.a_pad} aux rows; blocks main "
        f"{kern.block_main}, aux {kern.block_aux}, caveat {kern.block_cav} "
        f"rows a shard; aux passes {kern.aux_passes}, iteration cap "
        f"{kern.num_iters}; Leopard statuses {m._leopard.status_map()}")

    rng = np.random.default_rng(SEED + 13)
    users = w.subjects
    batches = [[SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
               for _ in range(1 + N_WARM)]
    pods = [p for p in prog.object_ids["pod"] if "\x00" not in p]
    pick = rng.choice(len(pods), N_CHECKS, replace=False)
    subj = rng.integers(0, LOOKUP_LANES, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("pod", pods[i]), "view", batches[0][s])
            for i, s in zip(pick, subj)]
    rebuilds0 = (m.stats["rebuilds"], ep.stats["rebuilds"])

    # the mesh path's read batches, launches and copies counted from zero
    kernels.reset_launches()
    collectives.reset_collectives()
    summary, lookups, checks = {}, [], []
    sweeps_all = 0
    for verb in ("lookup", "check"):
        e2e, sweeps = [], []
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            if verb == "lookup":
                lookups.append(asyncio.run(m.lookup_resources_batch(
                    "pod", "view", batches[k])))
            else:
                checks.append(asyncio.run(m.check_bulk_permissions(reqs)))
            timer.sync()
            e2e.append(time.perf_counter() - t0)
            sweeps.append(int(g.last_trace[0]))
        sweeps_all += sum(sweeps)
        summary[verb] = {"e2e_s": e2e, "sweeps": sweeps}
        log(f"mesh {verb}: sweeps per batch {sweeps}; trace "
            f"{g.last_trace[: 1 + sweeps[-1]].tolist()}; e2e per batch cold "
            f"{e2e[0]:.4f} s, warm median {statistics.median(e2e[1:]):.4f} s "
            f"(all: {', '.join(f'{t:.4f}' for t in e2e)})")
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    coll = {k: dict(v) for k, v in collectives.COLLECTIVES.items()}
    log(f"launches on the mesh path: {launches}")
    idle = [k for k in MESH_KERNELS if not launches[k]]
    if idle:
        raise AssertionError(f"kernels never launched on the mesh path: "
                             f"{idle}")
    # what a sweep costs in launches, copies and readbacks
    per_sweep = sum(launches[k] for k in MESH_SWEEP_KERNELS) / sweeps_all
    limit = MESH_DATA * (kern.aux_passes + 3 + len(prog.perm_ops))
    one_card = len({dev for row in mesh.devices for dev in row}) == 1
    q_arr, _, _ = m._encode_subjects(g, batches[0])
    ar = kern._alloc_arenas(len(q_arr) // 32)
    (_, tr), n_copies = _sweep_copies(kern, lambda: kern.evaluate(
        q_arr, len(q_arr) // 32, g.snapshot(), ar))
    log(f"mesh sweep: {per_sweep:g} launches a sweep (limit {limit}: "
        f"{MESH_DATA} x (aux passes {kern.aux_passes} + 3 + "
        f"{len(prog.perm_ops)} permission ops)); block copies "
        f"{coll['all_gather_rows']['copies']} over {sweeps_all} sweeps "
        f"({'every shard on one device' if one_card else 'several devices'}"
        f"); readbacks {coll['reduce_sweep_deltas']['calls']}; device "
        f"copies in one batch of {int(tr[0])} sweeps (input copies "
        f"included) {n_copies}")
    if per_sweep > limit:
        raise AssertionError(f"{per_sweep:g} launches a sweep > {limit}")
    if coll["reduce_sweep_deltas"]["calls"] != sweeps_all:
        raise AssertionError("not one readback a sweep")
    if one_card and (coll["all_gather_rows"]["copies"] or n_copies):
        raise AssertionError("a sweep copied between replicas on one card")
    cm = comm_model(prog.state_size, kern.a_pad, MESH_DATA, MESH_GRAPH,
                    LOOKUP_LANES, aux_passes=kern.aux_passes)
    per_sweep = coll["all_gather_rows"]["bytes"] / sweeps_all
    per_dev = per_sweep / mesh.size
    log(f"collectives over the mesh batches ({sweeps_all} sweeps): {coll}; "
        f"all_gather bytes per sweep {per_sweep:.0f}, per device "
        f"{per_dev:.0f}; comm_model "
        f"all_gather_recv_bytes_per_device_per_iter "
        f"{cm['all_gather_recv_bytes_per_device_per_iter']}")
    if per_dev != cm["all_gather_recv_bytes_per_device_per_iter"]:
        raise AssertionError("the all_gathers moved other bytes than "
                             "comm_model's")

    # the single-device ELL endpoint on the same batches, timed as the
    # mesh's were
    t0 = time.perf_counter()
    single = {"lookup": [], "check": []}
    for k in range(1 + N_WARM):
        t1 = time.perf_counter()
        one = asyncio.run(ep.lookup_resources_batch("pod", "view",
                                                    batches[k]))
        timer.sync()
        single["lookup"].append(time.perf_counter() - t1)
        if [sorted(x) for x in one] != [sorted(x) for x in lookups[k]]:
            raise AssertionError(f"mesh lookup batch {k} differs from the "
                                 "single-device endpoint's")
    for k in range(1 + N_WARM):
        t1 = time.perf_counter()
        one_c = asyncio.run(ep.check_bulk_permissions(reqs))
        timer.sync()
        single["check"].append(time.perf_counter() - t1)
        if [c.allowed for c in one_c] != [c.allowed for c in checks[k]]:
            raise AssertionError("mesh checks differ from the single-device "
                                 "endpoint's")
    for verb, e2e in single.items():
        summary[verb]["single_e2e_s"] = e2e
        log(f"single-device {verb} on the same batches: warm median "
            f"{statistics.median(e2e[1:]):.4f} s vs mesh "
            f"{statistics.median(summary[verb]['e2e_s'][1:]):.4f} s "
            f"(all: {', '.join(f'{t:.4f}' for t in e2e)})")
    log(f"mesh vs single device: {1 + N_WARM} lookup batches x "
        f"{LOOKUP_LANES} lanes and {1 + N_WARM} check batches x {len(reqs)} "
        f"pairs equal ({sum(len(x) for x in lookups[0])} allowed (subject, "
        f"pod) pairs, {sum(c.allowed for c in checks[0])} allowed checks; "
        f"{time.perf_counter() - t0:.1f} s)")

    sweep = mesh_sweep(kern, q_arr, len(q_arr) // 32, g.snapshot(), timer,
                       peak, "mesh multitenant-1m")
    sweep.update(launches_per_sweep=per_sweep, launch_limit=limit,
                 block_copies=coll["all_gather_rows"]["copies"],
                 batch_device_copies=n_copies)

    # churn through the shared store: both endpoints absorb it
    plan = _churn_plan(w, n_rounds, SEED + 13, tag="m")
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    scatter = 0
    for r, rnd in enumerate(plan):
        f0, a0 = m.stats["flush_s"], m.stats["delta_apply_s"]
        if r == n_rounds - 1:
            prev = (g.snapshot(), g.host_main.copy(), g.host_aux.copy())

        async def commit():
            for wr in rnd["writes"]:
                await m.write_relationships(
                    [RelationshipUpdate(ops[o], parse_relationship(rel))
                     for o, rel in wr])
        asyncio.run(commit())
        creators = list(dict.fromkeys(u for _, _, u in rnd["created"]))
        extra = [users[i] for i in rng.choice(len(users), LOOKUP_LANES,
                                              replace=False)]
        names = list(dict.fromkeys(creators + extra))[:LOOKUP_LANES]
        subjects = [SubjectRef("user", u) for u in names]
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = asyncio.run(m.lookup_resources_batch("pod", "view", subjects))
        timer.sync()
        t_lookup = time.perf_counter() - t0
        n_scatter = kernels.LAUNCHES["scatter_rows"]
        scatter += n_scatter
        if not n_scatter:
            raise AssertionError("the sharded flush launched no scatter_rows")
        if m.graph() is not g:
            raise AssertionError("the mesh endpoint rebuilt under churn")
        _mesh_tables_match(g)
        new = [(pod, u) for pod, _, u in rnd["created"]]
        pk = rng.choice(len(pods), N_CHECKS - len(new), replace=False)
        pairs = new + [(pods[i], names[j]) for i, j in
                       zip(pk, rng.integers(0, len(names), len(pk)))]
        creqs = [CheckRequest(ObjectRef("pod", p_), "view",
                              SubjectRef("user", u)) for p_, u in pairs]
        t0 = time.perf_counter()
        cres = asyncio.run(m.check_bulk_permissions(creqs))
        timer.sync()
        t_check = time.perf_counter() - t0
        one = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        one_c = asyncio.run(ep.check_bulk_permissions(creqs))
        if [sorted(a) for a in res] != [sorted(b) for b in one] or \
                [c.allowed for c in cres] != [c.allowed for c in one_c]:
            raise AssertionError(f"mesh and single-device answers differ "
                                 f"after churn round {r}")
        if not all(c.allowed for c in cres[: len(new)]):
            raise AssertionError("a creator cannot view the pod just created")
        log(f"mesh churn round {r}: {sum(len(x) for x in rnd['writes'])} "
            f"updates; delta application "
            f"{(m.stats['delta_apply_s'] - a0) * 1e3:.3f} ms, flush "
            f"{(m.stats['flush_s'] - f0) * 1e3:.3f} ms (host, {n_scatter} "
            f"scatter_rows launches); read-after-write lookup "
            f"{t_lookup:.4f} s, check {t_check:.4f} s (sweeps "
            f"{int(g.last_trace[0])}); every shard block equals the host "
            "table; answers equal the single-device endpoint's")
    if (m.stats["rebuilds"], ep.stats["rebuilds"]) != rebuilds0:
        raise AssertionError("a rebuild happened during the mesh churn")
    # the sharded flush's scatters at the last round's shapes: each
    # touched block of the main and aux tables, kernel against twin
    blocks_prev, main_prev, aux_prev = prev
    work = []
    for i, (host, old_host, b) in enumerate(
            ((g.host_main, main_prev, kern.block_main),
             (g.host_aux, aux_prev, kern.block_aux))):
        rows_c = np.nonzero((host != old_host).any(axis=1))[0]
        vals = kern.remap_values(host[rows_c])
        seen = set()
        for gg in np.unique(rows_c // b).tolist():
            sel = rows_c // b == gg
            for d in range(MESH_DATA):
                blk = blocks_prev[i][d][gg]
                if id(blk) in seen:
                    continue
                seen.add(id(blk))
                work.append((blk, torch.from_numpy(
                    (rows_c[sel] - gg * b).astype(np.int32)).to(blk.device),
                    torch.from_numpy(np.ascontiguousarray(vals[sel])).to(
                        blk.device)))
    s_err = max(_diff(kernels.scatter_rows(*a), reference.scatter_rows(*a))
                for a in work)
    s_ms = timer.ms(lambda: [kernels.scatter_rows(*a) for a in work])
    s_plain = timer.ms(lambda: [reference.scatter_rows(*a) for a in work])
    s_lib = timer.ms(lambda: [torch.index_put(b_, (r_.long(),), v_)
                              for b_, r_, v_ in work])
    s_bytes = sum(2 * b_.numel() * 4 + r_.numel() * 4 + v_.numel() * 4
                  for b_, r_, v_ in work)
    s_split = split_times(
        lambda: [kernels.scatter_rows(*a) for a in work],
        lambda: [torch.index_put(b_, (r_.long(),), v_)
                 for b_, r_, v_ in work]) if timer.cuda else {}
    if s_err:
        raise AssertionError(f"scatter_rows differs on the table blocks: "
                             f"{s_err}")
    log(f"sharded flush: the last round's {len(work)} touched (block, data "
        f"replica) scatters of the main and aux tables: bit-identical to "
        f"the twins; {s_ms:.6f} ms, twins {s_plain:.6f} ms, torch.index_put "
        f"{s_lib:.6f} ms, bound {s_bytes / peak * 1e3:.6f} ms over {s_bytes}"
        f" bytes")
    if s_split:
        _log_split("sharded flush scatter_rows", s_split)
    med = lambda v: statistics.median(v[1:])
    log(f"mesh summary: warm median lookup "
        f"{med(summary['lookup']['e2e_s']):.6f} s (single device on the "
        f"same batches {med(summary['lookup']['single_e2e_s']):.6f} s), "
        f"check {med(summary['check']['e2e_s']):.6f} s (single device "
        f"{med(summary['check']['single_e2e_s']):.6f} s); sweeps "
        f"{summary['lookup']['sweeps'][-1]} (lookup), "
        f"{summary['check']['sweeps'][-1]} (check); whole sweep "
        f"{sweep['sweep_ms']:.6f} ms (device-only "
        f"{sweep['attribution'].get('device_ms', float('nan')):.6f} ms) vs "
        f"bound {sweep['bound_ms']:.6f} ms (the first design's count "
        f"{sweep['old_bound_ms']:.6f} ms); scatter_rows launches {scatter} "
        f"({smi_line})")
    log(f"phase 13a wall time {time.perf_counter() - t_phase:.1f} s")
    out = {"launches": launches, "sweep": sweep, "summary": summary,
           "scatter": {"launches": scatter, "max_abs_err": s_err,
                       "ms": s_ms, "plain_ms": s_plain,
                       "bound_ms": s_bytes / peak * 1e3,
                       "library_ms": s_lib, **s_split}}
    return m, out


def or_chain(parts: list) -> None:
    """The all-reduce's library yardstick: the pairwise form in PyTorch
    calls, G - 1 `bitwise_or_` into parts[0], then G - 1 `copy_` back."""
    for t in parts[1:]:
        parts[0].bitwise_or_(t)
    for t in parts[1:]:
        t.copy_(parts[0])


def mesh_segment(seg, mesh, timer, peak, device: str = "cuda") -> dict:
    """Phase 13b: ShardedKernel (the edge-sharded segment sweep) at 2 x 4
    on the segment endpoint's program and current edge arrays; answers
    equal the segment endpoint's, the G-way `or_combine` against its twin
    on a real sweep's partials and timed beside the library chain.
    Returns the or_combine row and the sweep's numbers."""
    import dataclasses

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import (
        ShardedKernel)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)

    t_phase = time.perf_counter()
    g = seg.graph()                 # applies the deltas of phase 13a
    # the current edges, padding included, as the program's edge list
    prog = dataclasses.replace(g.prog, edge_src=g.host_src.copy(),
                               edge_dst=g.host_dst.copy())
    cap = len(g.host_src)
    sk = ShardedKernel(prog, mesh)
    src, dst = sk.device_edges(cap)
    users = [u for u in prog.object_ids["user"] if "\x00" not in u]
    rng = np.random.default_rng(SEED + 14)
    names = [users[i] for i in rng.choice(len(users), LOOKUP_LANES,
                                          replace=False)]
    q = np.asarray([prog.subject_index("user", u) for u in names], np.int32)
    subjects = [SubjectRef("user", u) for u in names]
    pods = [p for p in prog.object_ids["pod"] if "\x00" not in p]
    pick = rng.choice(len(pods), N_CHECKS, replace=False)
    cols = rng.integers(0, LOOKUP_LANES, N_CHECKS)
    gi = np.asarray([prog.state_index("pod", "view", pods[i]) for i in pick],
                    np.int32)
    off, length = prog.slot_range("pod", "view")
    kernels.reset_launches()
    collectives.reset_collectives()
    t0 = time.perf_counter()
    bitmap = sk.lookup(off, length, q, src, dst)
    timer.sync()
    t_lookup = time.perf_counter() - t0
    lk_sweeps = int(sk.last_trace[0])
    t0 = time.perf_counter()
    allowed = sk.checks(q, gi, cols, src, dst)
    t_check = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    coll = {k: dict(v) for k, v in collectives.COLLECTIVES.items()}
    log(f"ShardedKernel 2x4 on the segment program ({cap} edges, "
        f"{cap // MESH_GRAPH} a graph shard): lookup {t_lookup:.4f} s "
        f"({lk_sweeps} sweeps, trace "
        f"{sk.last_trace[:1 + lk_sweeps].tolist()}), check {t_check:.4f} s; "
        f"launches {launches}; collectives {coll}")
    idle = [k for k in ("seed_bitplanes", "edge_or", "or_combine",
                        "perm_program", "sweep_delta", "check_gather",
                        "lookup_T") if not launches[k]]
    if idle:
        raise AssertionError(f"kernels never launched by ShardedKernel: "
                             f"{idle}")
    ids = prog.object_ids["pod"]
    look = asyncio.run(seg.lookup_resources_batch("pod", "view", subjects))
    for j, got in enumerate(look):
        mine = sorted(ids[i] for i in np.nonzero(bitmap[:, j])[0]
                      if "\x00" not in ids[i])
        if mine != sorted(got):
            raise AssertionError(f"ShardedKernel lookup for {names[j]} "
                                 "differs from the segment endpoint's")
    creqs = [CheckRequest(ObjectRef("pod", pods[i]), "view", subjects[c])
             for i, c in zip(pick, cols)]
    seg_c = asyncio.run(seg.check_bulk_permissions(creqs))
    if [c.allowed for c in seg_c] != [bool(x) for x in allowed]:
        raise AssertionError("ShardedKernel checks differ from the segment "
                             "endpoint's")
    log(f"ShardedKernel answers equal the segment endpoint's: "
        f"{LOOKUP_LANES} lookups ({int(bitmap.sum())} allowed) and "
        f"{N_CHECKS} checks ({int(allowed.sum())} allowed)")

    # or_combine on a real sweep's partials, and one sweep's time
    n_words = MESH_DATA * max(1, LOOKUP_LANES // 32 // MESH_DATA)
    qp = np.full(32 * n_words, prog.dead_index, np.int32)
    qp[:LOOKUP_LANES] = q
    x0, live = sk.seed(qp, n_words)
    x = [[t.clone() for t in row] for row in x0]
    y = [[torch.empty_like(t) for t in row] for row in x0]
    for _ in range(2):
        sk.partials(y, x, x0, live, src, dst)
        for reps in y:
            collectives.or_allreduce(reps)
        sk.finish_step(y, x, x0, live)
        x, y = y, x
    sk.partials(y, x, x0, live, src, dst)
    # edge_or on every shard's own edges (W = n_words / D), against the
    # twin, from the shard's init step as the sweep runs it
    dead = prog.dead_index
    e_err = 0
    for d in range(MESH_DATA):
        for gg in range(MESH_GRAPH):
            init = torch.empty_like(x[d][gg])
            sk._caches[x[d][gg].device].run_step(
                ("init", sk._caches[x[d][gg].device]._wc_bits), init,
                x[d][gg], x0[d][gg], live[d][gg])
            a, b = init.clone(), init.clone()
            kernels.edge_or(a, x[d][gg], src[d][gg], dst[d][gg], dead=dead)
            reference.edge_or(b, x[d][gg], src[d][gg], dst[d][gg])
            e_err = max(e_err, _diff(a, b))
    if e_err:
        raise AssertionError(f"edge_or differs from its twin on a shard: "
                             f"{e_err}")
    log(f"edge_or vs twin on all {MESH_DATA * MESH_GRAPH} shards' edges "
        f"([{x[0][0].shape[0]}, {x[0][0].shape[1]}] states, "
        f"{src[0][0].numel()} edges a shard): bit-identical")
    # the all-reduce on a real sweep's partials: each data shard's G
    # replicas in one launch, against the twin
    err = 0
    for reps in y:
        a = [t.clone() for t in reps]
        b = [t.clone() for t in reps]
        kernels.or_combine(a)
        reference.or_combine(b)
        err = max(err, max(_diff(u, v) for u, v in zip(a, b)))
    if err:
        raise AssertionError("or_combine differs from its twin")

    # timed over every data shard's replicas (8 buffers, more than the
    # 50 MB L2 holds), per all-reduce of one data shard
    sets = [[t.clone() for t in reps] for reps in y]
    numel = sets[0][0].numel()
    per = len(sets)
    rows = {}
    _seg_rows(rows, "or_combine", err,
              timer.ms(lambda: [kernels.or_combine(s_) for s_ in sets]) / per,
              timer.ms(lambda: [reference.or_combine(s_)
                                for s_ in sets]) / per,
              2 * MESH_GRAPH * numel * 4, (MESH_GRAPH - 1) * numel, peak,
              library_ms=timer.ms(lambda: [or_chain(s_)
                                           for s_ in sets]) / per)
    del sets
    rows["or_combine"]["launches"] = launches["or_combine"]
    t_part = timer.ms(lambda: sk.partials(y, x, x0, live, src, dst))
    t_red = timer.ms(lambda: [collectives.or_allreduce(reps) for reps in y])
    t_fin = timer.ms(lambda: sk.finish_step(y, x, x0, live))
    t_delta = timer.ms(lambda: [kernels.sweep_delta(a_, b_, dead)
                                for ra, rb in zip(y, x)
                                for a_, b_ in zip(ra, rb)])
    t_plain = (timer.ms(lambda: sk.partials(y, x, x0, live, src, dst,
                                            reference), reps=2)
               + timer.ms(lambda: [collectives.or_allreduce(reps, reference)
                                   for reps in y], reps=2)
               + timer.ms(lambda: sk.finish_step(y, x, x0, live, reference),
                          reps=2))
    word = 4 * (n_words // MESH_DATA)
    n = prog.state_size
    nbytes = 0
    for d in range(MESH_DATA):
        for gg in range(MESH_GRAPH):
            s_, d_ = src[d][gg], dst[d][gg]
            nbytes += (s_.numel() * 8 + int(torch.unique(s_).numel()) * word
                       + 2 * int(torch.unique(d_).numel()) * word
                       + 2 * n * word          # init: seed in, partial out
                       + 2 * n * word)         # delta
            for code, _, length, *_ in sk._caches[s_.device]._ops:
                n_read = int((code[0::2] == 0).sum())
                nbytes += code.numel() * 4 + length * word * (n_read + 2)
    # the all-reduce: each of the G partials read once and each of the G
    # replicas written once
    nbytes += MESH_DATA * MESH_GRAPH * 2 * n * word
    sweep = {"partials_ms": t_part, "allreduce_ms": t_red,
             "finish_ms": t_fin, "delta_ms": t_delta,
             "sweep_ms": t_part + t_red + t_fin + t_delta,
             "plain_ms": t_plain, "bound_ms": nbytes / peak * 1e3,
             "bytes": nbytes, "sweeps": lk_sweeps}
    log(f"ShardedKernel sweep at {LOOKUP_LANES} lanes on 8 shards: "
        f"partials (init + edge_or) {t_part:.6f} ms, or_allreduce (one "
        f"or_combine a data shard) {t_red:.6f} ms, permission ops "
        f"{t_fin:.6f} ms, deltas "
        f"{t_delta:.6f} ms; whole sweep {sweep['sweep_ms']:.6f} ms, bound "
        f"{sweep['bound_ms']:.6f} ms over {nbytes} bytes; twins "
        f"{t_plain:.6f} ms. or_combine of {MESH_GRAPH} real partials [{n}, "
        f"{n_words // MESH_DATA}]: bit-identical, "
        f"{rows['or_combine']['ms']:.6f} ms a data shard (bound "
        f"{rows['or_combine']['bound_ms']:.6f}, twin "
        f"{rows['or_combine']['plain_ms']:.6f}, library chain of "
        f"{MESH_GRAPH - 1} bitwise_or_ + {MESH_GRAPH - 1} copy_ "
        f"{rows['or_combine']['library_ms']:.6f})")
    log(f"phase 13b wall time {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "sweep": sweep, "launches": launches}


def mesh_caveats(ep, w, mesh, timer, peak, device: str = "cuda") -> dict:
    """Phase 13c: the caveated deployment of phase 10 on a 2 x 4 mesh
    endpoint over its store: tri-state answers equal the single-device
    endpoint's, CONDITIONAL included, nothing routed to the oracle, the
    block-form `cav_gather_or` launched and equal to its twin."""
    import numpy as np

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)

    t_phase = time.perf_counter()
    m = _mesh_endpoint(ep.store, w.schema_text, mesh, device)
    t0 = time.perf_counter()
    g = m.graph()
    timer.sync()
    kern = g.kernel
    if not (g.has_cav and kern.planes):
        raise AssertionError("the caveated mesh graph compiled no planes")
    log(f"mesh caveats: build {time.perf_counter() - t0:.3f} s; caveat "
        f"table sharded {kern.block_cav} rows a shard over {kern.rows} "
        f"rows; aux passes {kern.aux_passes}, cap {kern.num_iters}")
    member_of, assigned, _ = _cav_index(w)
    prog = g.prog
    users = w.subjects
    pods = [p for p in prog.object_ids["pod"] if "\x00" not in p]
    rng = np.random.default_rng(SEED + 15)
    batches = [[SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
               for _ in range(2)]
    pairs = _cav_pairs(rng, [s.id for s in batches[0]], pods, member_of,
                       assigned, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("pod", p), "view", SubjectRef("user", u))
            for p, u in pairs]
    res0 = m.stats["oracle_residual_checks"]
    kernels.reset_launches()
    e2e = {"lookup": [], "check": []}
    looks, chks = [], []
    for bt in batches:
        t0 = time.perf_counter()
        looks.append(asyncio.run(m.lookup_resources_batch("pod", "view",
                                                          bt)))
        timer.sync()
        e2e["lookup"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        chks.append(asyncio.run(m.check_bulk_permissions(reqs)))
        timer.sync()
        e2e["check"].append(time.perf_counter() - t0)
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    log(f"mesh caveats: lookup e2e {e2e['lookup']}, check e2e "
        f"{e2e['check']} s; sweeps {int(g.last_trace[0])}, trace "
        f"{g.last_trace[:1 + int(g.last_trace[0])].tolist()}; launches "
        f"{launches}")
    idle = [k for k in MESH_SWEEP_KERNELS + (
        "mesh_cav_gather_or", "seed_bitplanes", "check_gather3",
        "lookup_T") if not launches[k]]
    if idle:
        raise AssertionError(f"kernels never launched on the caveated mesh "
                             f"path: {idle}")
    for bt, lk in zip(batches, looks):
        one = asyncio.run(ep.lookup_resources_batch("pod", "view", bt))
        if [sorted(x) for x in one] != [sorted(x) for x in lk]:
            raise AssertionError("caveated mesh lookups differ from the "
                                 "single-device endpoint's")
    one_c = _tri(asyncio.run(ep.check_bulk_permissions(reqs)))
    tri = _tri(chks[0])
    if tri != one_c or _tri(chks[1]) != tri:
        raise AssertionError("caveated mesh checks differ from the "
                             "single-device endpoint's")
    counts = {v: tri.count(v) for v in (2, 1, 0)}
    if not counts[1]:
        raise AssertionError("no CONDITIONAL answer on the mesh")
    if m.stats["oracle_residual_checks"] != res0 or any(
            r.source != "kernel" for c in chks for r in c):
        raise AssertionError("caveat rows were routed to the oracle")
    log(f"mesh caveats equal the single-device endpoint: HAS {counts[2]}, "
        f"CONDITIONAL {counts[1]}, NO {counts[0]} of {len(reqs)}; nothing "
        "routed to the oracle")
    # the plane path is the Jacobi step on both: one batch, one trace
    asyncio.run(m.lookup_resources_batch("pod", "view", batches[0]))
    asyncio.run(ep.lookup_resources_batch("pod", "view", batches[0]))
    tr_m, tr_1 = g.last_trace, ep.graph().last_trace
    if not np.array_equal(tr_m[:1 + tr_m[0]], tr_1[:1 + tr_1[0]]):
        raise AssertionError(f"the mesh's Jacobi trace "
                             f"{tr_m[:1 + tr_m[0]].tolist()} differs from "
                             f"the single-device one's "
                             f"{tr_1[:1 + tr_1[0]].tolist()}")
    log(f"mesh caveats: one lookup batch sweeps as on a single device: "
        f"trace {tr_m[:1 + tr_m[0]].tolist()} on both")
    q_arr, _, _ = m._encode_subjects(g, batches[0])
    sweep = mesh_sweep(kern, q_arr, len(q_arr) // 32, g.snapshot(), timer,
                       peak, "mesh caveats")
    log(f"phase 13c wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "sweep": sweep, "e2e": e2e}


def mesh_leopard(a, w, mesh, timer, device: str = "cuda") -> dict:
    """Phase 13d: group-explosion (phase 12's store) on a 2 x 4 mesh
    endpoint with the index on: `doc#view` indexed with its plane in one
    block per graph shard, reads served from the sharded plane with no
    sweep kernel, answers equal endpoint A's."""
    import numpy as np

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)

    t_phase = time.perf_counter()
    m = _mesh_endpoint(a.store, w.schema_text, mesh, device)
    t0 = time.perf_counter()
    m.graph()
    timer.sync()
    lp = m._leopard
    frag = lp.lookup_frag("doc", "view")
    if lp.status_map().get("doc#view") != "indexed" or frag is None:
        raise AssertionError(f"doc#view is not indexed on the mesh: "
                             f"{lp.status_map()}")
    if not isinstance(frag.plane, tuple) or len(frag.plane) != MESH_GRAPH:
        raise AssertionError("the plane is not sharded over the graph axis")
    log(f"mesh group-explosion: build {time.perf_counter() - t0:.3f} s; "
        f"doc#view plane in {len(frag.plane)} blocks of "
        f"{list(frag.plane[0].shape)} on "
        f"{[str(b.device) for b in frag.plane]} for {frag.plane_rows} rows")
    rng = np.random.default_rng(SEED + 16)
    n_users = len(w.subjects)
    subjects = [SubjectRef("user", w.subjects[i]) for i in
                rng.choice(n_users, LOOKUP_LANES, replace=False)]
    pairs, _ = _leo_pairs(w, rng, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("doc", d), "view", SubjectRef("user", u))
            for d, u in pairs]
    kernels.reset_launches()
    s0 = dict(m.stats)
    t0 = time.perf_counter()
    look = asyncio.run(m.lookup_resources_batch("doc", "view", subjects))
    timer.sync()
    t_look = time.perf_counter() - t0
    t0 = time.perf_counter()
    chk = asyncio.run(m.check_bulk_permissions(reqs))
    timer.sync()
    t_chk = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    served = {k: m.stats[k] - s0[k] for k in ("leopard_checks",
                                              "leopard_lookups",
                                              "kernel_calls")}
    swept = [k for k in ("ell_gather_or", "perm_program", "sweep_delta",
                         "seed_bitplanes", "lookup_T") if launches[k]]
    if swept or served["kernel_calls"] or served["leopard_checks"] != \
            len(reqs) or not (launches["check_gather"]
                              and launches["word_cols_T"]):
        raise AssertionError(f"the mesh reads were not served from the "
                             f"sharded plane: {served}, {launches}")
    a_l = asyncio.run(a.lookup_resources_batch("doc", "view", subjects))
    a_c = asyncio.run(a.check_bulk_permissions(reqs))
    if [sorted(x) for x in look] != [sorted(x) for x in a_l] or \
            [c.allowed for c in chk] != [c.allowed for c in a_c]:
        raise AssertionError("mesh plane answers differ from endpoint A's")
    log(f"mesh group-explosion reads from the sharded plane: lookup "
        f"{t_look:.4f} s, check {t_chk:.4f} s (cold); served {served}; "
        f"launches check_gather {launches['check_gather']}, word_cols_T "
        f"{launches['word_cols_T']}, no sweep kernel; answers equal A's "
        f"({sum(c.allowed for c in chk)} HAS of {len(reqs)})")
    log(f"phase 13d wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


def _concurrent(calls: list) -> tuple:
    """Run the coroutine factories `calls` concurrently in one new event
    loop: (results in call order, each call's seconds from the common
    start to its answer, wall seconds)."""
    async def go():
        t0 = time.perf_counter()
        lat = [0.0] * len(calls)

        async def timed(i, make):
            out = await make()
            lat[i] = time.perf_counter() - t0
            return out

        res = await asyncio.gather(*(timed(i, c) for i, c in
                                     enumerate(calls)))
        return list(res), lat, time.perf_counter() - t0

    return asyncio.run(go())


def _pcts(xs: list) -> str:
    import numpy as np
    p50, p99 = np.percentile(np.asarray(xs), [50, 99])
    return f"p50 {p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms"


def batched_dispatch(ep, w, smi_line: str, device: str = "cuda") -> dict:
    """Phase 14: cross-request batched dispatch on the phase-3 endpoint,
    wrapped in the port's `BatchingEndpoint` (no second graph is built).
    (a) BASELINE config 5: 256 concurrent `lookup_resources` calls, one
    per user, must answer as one direct 256-lane batch, in fewer than 256
    inner kernel calls and fused batches of more than one; (b) 64
    concurrent `check_bulk_permissions` calls (10,000 pairs in all)
    interleaved with 256 concurrent lookups must answer as the direct
    endpoint; every read kernel must launch in (a)-(b); (e) the side-stream
    readback ran once for every fused batch, and a readback's bytes equal
    a blocking copy of the same result; (c) (a) and (b) at pipeline depth
    1 and 2 and through the direct endpoint, DISPATCH_REPEATS runs each,
    interleaved: wall times, per-request p50/p99 and batch counts; (d) a
    lookup and a check batch started before one round of phase 9's churn
    and finished after its flush and sweep-graph recapture return the
    pre-write answers.  A fixed-seed sample of (a)-(b) equals the oracle."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import _Readback
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.dispatch import (
        BatchingEndpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, CheckResult, ObjectRef, RelationshipUpdate, SubjectRef,
        UpdateOp, parse_relationship)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    users = w.subjects
    subjects = [SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
    want_lr = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
    pods = [p for p in ep.graph().prog.object_ids["pod"] if "\x00" not in p]
    # half the pairs from the subjects' own answers, half at random
    reqs = []
    for k in range(N_CHECKS):
        s = int(rng.integers(0, LOOKUP_LANES))
        own = want_lr[s]
        pod = (own[int(rng.integers(0, len(own)))] if k % 2 and len(own)
               else pods[int(rng.integers(0, len(pods)))])
        reqs.append(CheckRequest(ObjectRef("pod", pod), "view",
                                 subjects[s]))
    want_ck = [r.permissionship for r in
               asyncio.run(ep.check_bulk_permissions(reqs))]
    cuts = np.linspace(0, N_CHECKS, DISPATCH_CHECK_CALLS + 1).astype(int)
    chunks = [reqs[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    per_chunk = LOOKUP_LANES // DISPATCH_CHECK_CALLS

    def calls_a(target):
        return [lambda s=s: target.lookup_resources("pod", "view", s)
                for s in subjects]

    def calls_b(target):
        """Lookups and check calls interleaved: a check call after every
        `per_chunk` lookups."""
        out = []
        for i, s in enumerate(subjects):
            out.append(lambda s=s: target.lookup_resources("pod", "view", s))
            if i % per_chunk == per_chunk - 1:
                out.append(lambda c=chunks[i // per_chunk]:
                           target.check_bulk_permissions(c))
        return out

    def split_b(res, lat):
        """(lookup answers, check answers, lookup and check latencies)."""
        lr, ck, lat_l, lat_c = [], [], [], []
        for r, t in zip(res, lat):
            if isinstance(r, list) and r and isinstance(r[0], CheckResult):
                ck.extend(x.permissionship for x in r)
                lat_c.append(t)
            else:
                lr.append(list(r))
                lat_l.append(t)
        return lr, ck, lat_l, lat_c

    want_lists = [list(x) for x in want_lr]

    def agree(lr, ck, what):
        if lr is not None and lr != want_lists:
            bad = sum(a != b for a, b in zip(lr, want_lists))
            raise AssertionError(f"{what}: {bad} of {len(lr)} lookups differ "
                                 f"from the direct 256-lane batch")
        if ck is not None and ck != want_ck:
            bad = sum(a != b for a, b in zip(ck, want_ck))
            raise AssertionError(f"{what}: {bad} of {len(ck)} checks differ "
                                 f"from the direct endpoint")

    # (a) + (b) through the dispatcher at depth 2, launches counted from 0
    bep = BatchingEndpoint(ep, pipeline_depth=2)
    s0 = bep.stats
    kernels.reset_launches()
    res_a, lat_a, wall_a = _concurrent(calls_a(bep))
    s1 = bep.stats
    res_b, lat_b, wall_b = _concurrent(calls_b(bep))
    launches = {k: kernels.LAUNCHES[k] for k in READ_KERNELS}
    s2 = bep.stats
    agree([list(x) for x in res_a], None, "(a) batched")
    calls_made = s1["kernel_calls"] - s0["kernel_calls"]
    fused_a = (s1["fused_lookups"] - s0["fused_lookups"])
    if not calls_made < LOOKUP_LANES or s1["max_fused_batch"] <= 1:
        raise AssertionError(f"(a) did not batch: {calls_made} kernel calls, "
                             f"max fused batch {s1['max_fused_batch']}")
    log(f"dispatch (a): {LOOKUP_LANES} concurrent lookup_resources calls "
        f"answered as the direct {LOOKUP_LANES}-lane batch in {wall_a:.4f} s: "
        f"{calls_made} kernel calls, {fused_a} fused lookup batches, max "
        f"fused batch {s1['max_fused_batch']}; per request "
        f"{_pcts(lat_a)}; {smi_line}")
    lr_b, ck_b, lat_bl, lat_bc = split_b(res_b, lat_b)
    agree(lr_b, ck_b, "(b) batched")
    log(f"dispatch (b): {DISPATCH_CHECK_CALLS} concurrent "
        f"check_bulk_permissions calls ({N_CHECKS} pairs) and "
        f"{LOOKUP_LANES} lookups interleaved answered as the direct endpoint "
        f"in {wall_b:.4f} s: {s2['fused_checks'] - s1['fused_checks']} fused "
        f"check and {s2['fused_lookups'] - s1['fused_lookups']} fused lookup "
        f"batches, {s2['kernel_calls'] - s1['kernel_calls']} kernel calls; "
        f"lookups {_pcts(lat_bl)}, check calls {_pcts(lat_bc)}")
    log(f"launches on the batched path (a)-(b): {launches}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle and device == "cuda":    # the CPU runs the twins, uncounted
        raise AssertionError(f"kernels never launched on the batched path: "
                             f"{idle}")

    # the oracle, on a fixed-seed sample: checks, and each sampled
    # subject's lookup through checks of its allowed and refused pods
    oracle = ep._oracle
    t0 = time.perf_counter()
    for i in rng.choice(N_CHECKS, DISPATCH_ORACLE_CHECKS, replace=False):
        r = reqs[i]
        if oracle.check3(r.resource, r.permission, r.subject) != \
                {"NO_PERMISSION": 0, "CONDITIONAL_PERMISSION": 1,
                 "HAS_PERMISSION": 2}[ck_b[i].name]:
            raise AssertionError(f"check {r} differs from the oracle")
    n_held = 0
    for j in rng.choice(LOOKUP_LANES, DISPATCH_ORACLE_SUBJECTS,
                        replace=False):
        got = set(res_a[j])
        allowed = sorted(got)
        refused = [p for p in (pods[int(i)] for i in
                               rng.choice(len(pods), 4 * DISPATCH_ORACLE_PODS,
                                          replace=False))
                   if p not in got][:DISPATCH_ORACLE_PODS]
        for want, sample in ((True, [allowed[int(i)] for i in rng.choice(
                len(allowed), min(len(allowed), DISPATCH_ORACLE_PODS),
                replace=False)] if allowed else []), (False, refused)):
            for pod in sample:
                if oracle.check(ObjectRef("pod", pod), "view",
                                subjects[j]) != want:
                    raise AssertionError(f"lookup of {subjects[j]} differs "
                                         f"from the oracle at {pod}")
                n_held += 1
    log(f"dispatch oracle: {DISPATCH_ORACLE_CHECKS} checks of (b) and "
        f"{n_held} checks of {DISPATCH_ORACLE_SUBJECTS} lookups of (a) "
        f"(allowed and refused pods) equal the oracle "
        f"({time.perf_counter() - t0:.1f} s)")

    # (e) the readback: one side-stream copy for every fused batch (nothing
    # is served from a closure plane at multitenant-1m), and its bytes
    # equal a blocking copy of the same result
    fused = (s2["fused_lookups"] + s2["fused_checks"]
             - s0["fused_lookups"] - s0["fused_checks"])
    rbs = s2["readbacks"] - s0["readbacks"]
    g = ep.graph()
    q_arr, cols, _ = ep._encode_subjects(g, subjects)
    off, length = g.prog.slot_range("pod", "view")
    dev_l, _, _ = g.run_lookup_packed_T_device(off, length, q_arr)
    gi = [g.prog.state_index("pod", "view", r.resource.id)
          for r in chunks[0]]
    gc = [cols[r.subject] for r in chunks[0]]
    dev_c, _, _ = g.run_checks3_device(q_arr, gi, gc)
    same, times = [], []
    for dev in (dev_l, dev_c):
        rb = _Readback(dev)
        host = rb.wait()
        blocking = dev.cpu()
        same.append(bool(torch.equal(host, blocking)))
        if device == "cuda" and not (rb.event is not None
                                     and host.is_pinned()):
            raise AssertionError("the readback did not go through a pinned "
                                 "side-stream copy")
        # host ms of each way, the result already computed (median of 10)
        for fn in (lambda: _Readback(dev).wait(), dev.cpu):
            ts = []
            for _ in range(10):
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            times.append(statistics.median(ts))
    if device == "cuda" and rbs != fused:
        raise AssertionError(f"{rbs} side-stream readbacks for {fused} fused "
                             f"batches")
    if not all(same):
        raise AssertionError(f"a readback differs from a blocking copy of the "
                             f"same result: {same}")
    log(f"dispatch (e): {rbs} side-stream readbacks ({s2['readback_bytes'] - s0['readback_bytes']} "
        f"bytes) for {fused} fused batches; a lookup's [W, L] words and a "
        f"check batch's values read back equal to a blocking .cpu() copy; "
        f"host ms (median of 10), side-stream readback vs .cpu(): words "
        f"{times[0]:.4f} vs {times[1]:.4f} ({dev_l.numel() * 4} B), check "
        f"values {times[2]:.4f} vs {times[3]:.4f} ({dev_c.numel() * 4} B)")

    # (c) depth 1, depth 2 and direct dispatch, interleaved per repeat
    modes = {"depth 1": BatchingEndpoint(ep, pipeline_depth=1),
             "depth 2": BatchingEndpoint(ep, pipeline_depth=2),
             "direct": ep}
    runs = {(m, part): [] for m in modes for part in "ab"}
    for _ in range(DISPATCH_REPEATS):
        for m, target in modes.items():
            for part in "ab":
                st0 = dict(target.stats)
                res, lat, wall = _concurrent(
                    (calls_a if part == "a" else calls_b)(target))
                st1 = dict(target.stats)
                if part == "a":
                    agree([list(x) for x in res], None, f"(c) {m} (a)")
                    lat_l, lat_c = lat, []
                else:
                    lr, ck, lat_l, lat_c = split_b(res, lat)
                    agree(lr, ck, f"(c) {m} (b)")
                runs[(m, part)].append({
                    "wall": wall, "lat_l": lat_l, "lat_c": lat_c,
                    "calls": st1["kernel_calls"] - st0["kernel_calls"],
                    "fused": sum(st1.get(k, 0) - st0.get(k, 0) for k in
                                 ("fused_lookups", "fused_checks"))})
    summary = {}
    for (m, part), rs in runs.items():
        lat_l = [t for r in rs for t in r["lat_l"]]
        lat_c = [t for r in rs for t in r["lat_c"]]
        walls = [r["wall"] for r in rs]
        summary[(m, part)] = statistics.median(walls)
        log(f"dispatch (c) {m}, ({part}): median wall "
            f"{statistics.median(walls):.4f} s (all: "
            f"{', '.join(f'{t:.4f}' for t in walls)}); lookups "
            f"{_pcts(lat_l)}"
            + (f"; check calls {_pcts(lat_c)}" if lat_c else "")
            + f"; fused batches {[r['fused'] for r in rs]}, kernel calls "
            f"{[r['calls'] for r in rs]}; {smi_line}")

    # (d) batches started before a churn round finish on their snapshot
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    rnd = _churn_plan(w, 1, SEED + 14, tag="d")[0]
    creators = list(dict.fromkeys(u for _, _, u in rnd["created"]))
    d_subj = [SubjectRef("user", u) for u in creators]
    d_subj += [s for s in subjects if s.id not in set(creators)]
    d_subj = d_subj[:LOOKUP_LANES]
    d_reqs = [CheckRequest(ObjectRef("pod", pod), "view",
                           SubjectRef("user", u))
              for pod, _, u in rnd["created"]] + chunks[0]
    before_l = [list(x) for x in asyncio.run(
        ep.lookup_resources_batch("pod", "view", d_subj))]
    before_c = [r.permissionship for r in
                asyncio.run(ep.check_bulk_permissions(d_reqs))]
    ctx_l = asyncio.run(ep.lookup_resources_batch_start("pod", "view",
                                                        d_subj))
    ctx_c = asyncio.run(ep.check_bulk_permissions_start(d_reqs))
    st0 = dict(ep.stats)
    gs0 = dict(ep.graph().kernel.graph_stats)

    async def commit(writes):
        for wr in writes:
            await ep.write_relationships(
                [RelationshipUpdate(ops[o], parse_relationship(r))
                 for o, r in wr])

    asyncio.run(commit(rnd["writes"]))
    after_l = [list(x) for x in asyncio.run(
        ep.lookup_resources_batch("pod", "view", d_subj))]
    gs1 = ep.graph().kernel.graph_stats
    st1 = ep.stats
    if not (st1["delta_batches"] > st0["delta_batches"]
            and st1["rebuilds"] == st0["rebuilds"]
            and (device != "cuda" or gs1["captures"] > gs0["captures"])):
        raise AssertionError("the churn round did not flush and recapture "
                             "without a rebuild")
    fin_l = [list(x) for x in asyncio.run(
        ep.lookup_resources_batch_finish(ctx_l))]
    fin_c = [r.permissionship for r in asyncio.run(
        ep.check_bulk_permissions_finish(ctx_c))]
    changed = sum(a != b for a, b in zip(after_l, before_l))
    if fin_l != before_l or fin_c != before_c or not changed:
        raise AssertionError(
            f"(d): started batches did not keep their snapshot's answers "
            f"(lookups equal {fin_l == before_l}, checks equal "
            f"{fin_c == before_c}, {changed} answers changed by the writes)")
    log(f"dispatch (d): a {len(d_subj)}-lane lookup batch and a "
        f"{len(d_reqs)}-pair check batch started before a churn round "
        f"finished after its flush ({st1['delta_batches'] - st0['delta_batches']} "
        f"flushes, {gs1['captures'] - gs0['captures']} sweep graph captures, "
        f"no rebuild) with their pre-write answers; {changed} of "
        f"{len(d_subj)} lookups have since changed")
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "summary": summary}

# -- phase 15, off-loop rebuilds ------------------------------------------------

def _hold(ep, name: str, gate, reached=None, before: bool = True):
    """Make `ep.<name>` (a candidate build step) wait for `gate` before
    (or after) it runs, setting `reached` when it gets there.  Returns a
    function that restores the method."""
    import threading
    orig = getattr(ep, name)
    reached = reached if reached is not None else threading.Event()

    def held(*args):
        if before:
            reached.set()
            if not gate.wait(timeout=600):
                raise RuntimeError(f"{name} held for 600 s")
        out = orig(*args)
        if not before:
            reached.set()
            if not gate.wait(timeout=600):
                raise RuntimeError(f"{name} held for 600 s")
        return out

    setattr(ep, name, held)
    return lambda: delattr(ep, name)


def _switch(on: bool) -> None:
    """The port's ASYNC_REBUILD switch (phases 1-14 run with it off: each
    asserts that its churn rebuilds nothing)."""
    from spicedb_kubeapi_proxy_tpu_torch.utils import features
    features.ASYNC_REBUILD = on


def background_swap(x_ep, label: str) -> None:
    """One background swap on `x_ep` (switch on, candidate prewarmed):
    the rebuild is kicked directly, as a preemptive one would be, and
    `wait_rebuilds()` must see it installed with no failure."""
    _switch(True)
    try:
        x_ep.prewarm_rebuilds = True
        n0 = x_ep.stats["bg_rebuilds"]
        gen = x_ep._graph
        with x_ep._lock:
            x_ep._kick_background_rebuild("background")
        if not x_ep.wait_rebuilds(timeout=600):
            raise AssertionError(f"{label}: the background rebuild did not "
                                 "finish")
        if (x_ep.stats["bg_rebuilds"] != n0 + 1 or x_ep._graph is gen
                or x_ep.stats["rebuild_failures"]):
            raise AssertionError(f"{label}: no background swap "
                                 f"({x_ep.stats['bg_rebuilds'] - n0} "
                                 f"installs, "
                                 f"{x_ep.stats['rebuild_failures']} failures)")
    finally:
        x_ep.prewarm_rebuilds = False
        _switch(False)
    log(f"{label}: one background swap (candidate prewarmed), "
        f"{x_ep.stats['bg_install_s'] * 1e3:.3f} ms of lock-held installs "
        "so far")


def swap_and_agree(x_ep, ref_ep, rt: str, perm: str, subjects: list,
                   reqs: list, label: str) -> None:
    """One background swap on `x_ep`; before and after it, and on
    `ref_ep` (the single-device endpoint), the lookups and tri-state
    checks are equal, and a sample of the checks equals the oracle's."""
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)

    def answers(e):
        looked = [sorted(x) for x in asyncio.run(
            e.lookup_resources_batch(rt, perm, subjects))]
        checked = [r.permissionship for r in asyncio.run(
            e.check_bulk_permissions(reqs))]
        return looked, checked

    before = answers(x_ep)
    background_swap(x_ep, label)
    after = answers(x_ep)
    if after != before or after != answers(ref_ep):
        raise AssertionError(f"{label}: answers changed across the swap or "
                             "differ from the single-device endpoint's")
    tri = TorchEndpoint._TRISTATE
    bad = sum(tri[x_ep._oracle.check3(r.resource, r.permission, r.subject)]
              != after[1][i] for i, r in
              enumerate(reqs[:OFFLOOP_SWAP_ORACLE]))
    if bad:
        raise AssertionError(f"{label}: {bad} checks differ from the oracle")
    log(f"{label}: after the swap {len(subjects)} lookups and {len(reqs)} "
        f"tri-state checks equal those before it and the single-device "
        f"endpoint's; {OFFLOOP_SWAP_ORACLE} equal the oracle's")


def offloop_rebuild(ep, w, batches, reqs, smi_line: str,
                    device: str = "cuda") -> dict:
    """Phase 15: off-loop rebuilds at multitenant-1m, on the phase-3
    store.  (a) a fresh endpoint with `warm_start(prewarm=True)`: its
    first 256-lane lookup and 10,000-pair check batches run no eager
    sweep, make no capture and answer as the phase-3 endpoint; (b)
    unique-name pods created on spare rows past the pool's 25 % low
    watermark while a reader thread issues 256-lane pod#view lookup
    batches, once with ASYNC_REBUILD on (a preemptive background rebuild,
    no quarantine) and once off (the pool runs dry and the rebuild lands
    on a read): the reader's p50/p99/max, the lock-held install and the
    card's memory before, at its peak during and after the swap; (c)
    more new tenants in one write than the tenant pool holds: pod#view
    is quarantined to the oracle while the (held) candidate waits, a
    pair outside the closure (group#member) stays on the kernel, and
    after the swap the tables equal the host's and the answers equal a
    `force_rebuild()`'s and the oracle's; (d) launches counted from zero
    over one background swap with writes replayed at its install: the
    candidate's prewarm and replay flush launch every read kernel and
    `scatter_rows`.  Returns the launches of (d)."""
    import threading
    import weakref

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, Permissionship, RelationshipUpdate,
        SubjectRef, UpdateOp, parse_relationship)

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    rng = np.random.default_rng(SEED + 15)
    subjects = batches[0]
    ep.wait_rebuilds()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def answers(x_ep):
        looked = [sorted(x) for x in asyncio.run(
            x_ep.lookup_resources_batch("pod", "view", subjects))]
        checked = [r.permissionship for r in asyncio.run(
            x_ep.check_bulk_permissions(reqs))]
        return looked, checked

    # (a) a fresh endpoint on the store, prewarmed at its warm start
    _switch(True)
    t0 = time.perf_counter()
    fresh = create_endpoint(direct_url(device), Bootstrap(w.schema_text, ""),
                            store=ep.store)
    fresh.warm_start(prewarm=True)
    sync()
    t_warm = time.perf_counter() - t0
    g = fresh.graph()
    gs0 = dict(g.kernel.graph_stats)
    buckets = sorted(g.kernel._arenas)
    ranges = fresh._prewarm_slot_ranges(g)
    log(f"offloop (a): warm_start(prewarm=True) {t_warm:.3f} s (graph build "
        f"and prewarm): {len(buckets)} lane buckets warmed ({[32 * b for b in buckets]} "
        f"lanes) x {len(ranges)} lookup slot ranges + checks, "
        f"{gs0['captures']} sweep graph captures, {gs0['eager_sweeps']} "
        f"eager sweeps")
    t0 = time.perf_counter()
    got = answers(fresh)
    sync()
    t_first = time.perf_counter() - t0
    gs1 = dict(fresh.graph().kernel.graph_stats)
    if gs1["eager_sweeps"] != gs0["eager_sweeps"] or \
            gs1["captures"] != gs0["captures"]:
        raise AssertionError(f"(a): the first batches after the prewarm ran "
                             f"{gs1['eager_sweeps'] - gs0['eager_sweeps']} "
                             f"eager sweeps and made "
                             f"{gs1['captures'] - gs0['captures']} captures")
    if got != answers(ep):
        raise AssertionError("(a): the prewarmed endpoint's answers differ "
                             "from the phase-3 endpoint's")
    log(f"offloop (a): first {LOOKUP_LANES}-lane lookup and {len(reqs)}-pair "
        f"check batches after the prewarm {t_first:.4f} s: 0 eager sweeps, 0 "
        f"captures, {gs1['replays'] - gs0['replays']} graph replays; answers "
        "equal the phase-3 endpoint's")
    del g      # hold no generation: (b) checks that a swap frees it

    # (b) unique-name pod churn past the watermark under a reader
    ns_of = [n for n in fresh.graph().prog.object_ids["namespace"]
             if "\x00" not in n]
    users = w.subjects

    def create_pods(x_ep, tag: str, n: int) -> list:
        made = []
        for i in range(n):
            ns = ns_of[int(rng.integers(len(ns_of)))]
            u = users[int(rng.integers(len(users)))]
            pod = f"{ns}/{tag}-{i}"
            x_ep.store.write([
                RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(
                    f"pod:{pod}#namespace@namespace:{ns}")),
                RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(
                    f"pod:{pod}#creator@user:{u}"))])
            made.append((pod, u))
            if i % OFFLOOP_WRITE_PODS == OFFLOOP_WRITE_PODS - 1:
                time.sleep(OFFLOOP_WRITE_GAP_S)
        return made

    def churn_run(on: bool, tag: str) -> dict:
        _switch(on)
        fresh.wait_rebuilds()
        pool = len(fresh._spare_pool["pod"])
        n = pool + OFFLOOP_EXTRA_PODS
        st0 = dict(fresh.stats)
        outgoing = weakref.ref(fresh._graph)
        gc.collect()
        sync()
        mem0 = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        stop = threading.Event()
        lat, errors = [], []

        def reader():
            try:
                while not stop.is_set():
                    t = time.perf_counter()
                    asyncio.run(fresh.lookup_resources_batch(
                        "pod", "view", subjects))
                    lat.append(time.perf_counter() - t)
            except Exception as e:      # raised by the main thread
                errors.append(e)

        def no_oracle_lookups(*args):
            # a quarantined pod#view lookup would go to the host oracle
            # (minutes a subject at this size): fail at once instead
            raise AssertionError("(b): a pod#view lookup was routed to the "
                                 "oracle")

        fresh._oracle.lookup_resources = no_oracle_lookups
        th = threading.Thread(target=reader)
        th.start()
        t0 = time.perf_counter()
        try:
            made = create_pods(fresh, tag, n)
            t_write = time.perf_counter() - t0
            time.sleep(0.5)     # the reader applies the last writes
            if not fresh.wait_rebuilds(timeout=600):
                raise AssertionError("(b): background rebuilds did not "
                                     "settle")
        finally:
            stop.set()
            th.join(timeout=600)
            del fresh._oracle.lookup_resources
        if th.is_alive():
            raise AssertionError("(b): the reader thread did not stop")
        if errors:
            raise errors[0]
        gc.collect()
        sync()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        mem1 = torch.cuda.memory_allocated() if on_card else 0
        d = {k: fresh.stats[k] - st0[k] for k in
             ("rebuilds", "bg_rebuilds", "preemptive_rebuilds",
              "stale_routed", "stale_pair_marks", "spare_assignments")}
        p50, p99 = np.percentile(np.asarray(lat), [50, 99])
        if outgoing() is not None:
            raise AssertionError("(b): the outgoing generation is still "
                                 "alive after the swap")
        out = {"pool": pool, "pods": n, "write_s": t_write,
               "reads": len(lat), "p50_s": float(p50), "p99_s": float(p99),
               "max_s": max(lat), "install_ms": (fresh.stats["bg_install_s"]
                                                 - st0["bg_install_s"]) * 1e3,
               "mem_mb": (mem0 / 2 ** 20, peak / 2 ** 20, mem1 / 2 ** 20),
               **d}
        log(f"offloop (b) ASYNC_REBUILD {'on' if on else 'off'}: {n} pods "
            f"created on a {pool}-row spare pool in {t_write:.2f} s; reader "
            f"{len(lat)} {LOOKUP_LANES}-lane lookup batches p50 "
            f"{p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms, max "
            f"{max(lat) * 1e3:.3f} ms; rebuilds {d['rebuilds']} (background "
            f"{d['bg_rebuilds']}, preemptive {d['preemptive_rebuilds']}), "
            f"stale pairs {d['stale_pair_marks']}, stale-routed reads "
            f"{d['stale_routed']}; lock-held install {out['install_ms']:.3f} "
            f"ms; card memory before {out['mem_mb'][0]:.1f} MiB, peak "
            f"{out['mem_mb'][1]:.1f} MiB, after {out['mem_mb'][2]:.1f} MiB "
            f"({smi_line})")
        # the creators see their pods
        sample = made[:: max(1, len(made) // 500)]
        res = asyncio.run(fresh.check_bulk_permissions(
            [CheckRequest(ObjectRef("pod", p), "view", SubjectRef("user", u))
             for p, u in sample]))
        if not all(r.allowed for r in res):
            raise AssertionError("(b): a creator cannot view a created pod")
        _tables_match(fresh.graph())
        return out

    runs = {"on": churn_run(True, "q15on")}
    fresh.force_rebuild()           # a full pool again for the other run
    runs["off"] = churn_run(False, "q15off")
    on, off = runs["on"], runs["off"]
    if on["preemptive_rebuilds"] < 1 or on["stale_routed"] or \
            on["stale_pair_marks"]:
        raise AssertionError(f"(b) on: expected a preemptive rebuild and no "
                             f"quarantine: {on}")
    if off["rebuilds"] < 1 or off["bg_rebuilds"]:
        raise AssertionError(f"(b) off: expected a synchronous rebuild: {off}")

    # (c) a forced quarantine: more new tenants than the tenant pool holds
    _switch(True)
    fresh.wait_rebuilds()
    t_pool = len(fresh._spare_pool["tenant"])
    n_t = t_pool + OFFLOOP_EXTRA_TENANTS
    new_t = [(f"tq{k}", users[int(rng.integers(len(users)))])
             for k in range(n_t)]
    gate = threading.Event()
    restore = _hold(fresh, "_build_candidate", gate)
    st0 = dict(fresh.stats)
    try:
        fresh.store.write([RelationshipUpdate(UpdateOp.TOUCH,
                                              parse_relationship(
                                                  f"tenant:{t}#member@user:{u}"))
                           for t, u in new_t])
        pick = rng.choice(len(reqs), OFFLOOP_ORACLE_CHECKS, replace=False)
        q_reqs = [reqs[i] for i in pick]
        t0 = time.perf_counter()
        routed = asyncio.run(fresh.check_bulk_permissions(q_reqs))
        t_routed = time.perf_counter() - t0
        n_routed = fresh.stats["stale_routed"] - st0["stale_routed"]
        if ("pod", "view") not in fresh._stale_pairs or \
                n_routed != len(q_reqs) or \
                any(r.source != "oracle" for r in routed):
            raise AssertionError(f"(c): pod#view was not quarantined "
                                 f"({n_routed} routed)")
        if any(r.allowed != fresh._oracle.check(q.resource, q.permission,
                                                 q.subject)
               for r, q in zip(routed, q_reqs)):
            raise AssertionError("(c): quarantined answers differ from the "
                                 "oracle's")
        t0 = time.perf_counter()
        members = asyncio.run(fresh.lookup_resources_batch(
            "group", "member", subjects))
        t_outside = time.perf_counter() - t0
        if (fresh.stats["stale_routed"] - st0["stale_routed"] != n_routed
                or any(x.source != "kernel" for x in members)
                or not fresh.rebuild_inflight):
            raise AssertionError("(c): group#member left the kernel, or the "
                                 "build was not in flight")
        access = asyncio.run(fresh.check_bulk_permissions(
            [CheckRequest(ObjectRef("tenant", t), "access",
                          SubjectRef("user", u)) for t, u in new_t]))
        if not all(r.allowed for r in access):
            raise AssertionError("(c): a new tenant member has no access")
    finally:
        gate.set()
        restore()
    if not fresh.wait_rebuilds(timeout=600):
        raise AssertionError("(c): the background rebuild did not finish")
    d = {k: fresh.stats[k] - st0[k] for k in
         ("rebuilds", "bg_rebuilds", "stale_pair_marks", "stale_routed")}
    if d["bg_rebuilds"] < 1 or fresh._stale_pairs:
        raise AssertionError(f"(c): no clean background swap: {d}")
    _tables_match(fresh.graph())
    swapped = answers(fresh)
    access = [r.permissionship for r in asyncio.run(
        fresh.check_bulk_permissions(
            [CheckRequest(ObjectRef("tenant", t), "access",
                          SubjectRef("user", u)) for t, u in new_t]))]
    fresh.force_rebuild()
    if answers(fresh) != swapped or access != [r.permissionship for r in
                                                asyncio.run(
            fresh.check_bulk_permissions(
                [CheckRequest(ObjectRef("tenant", t), "access",
                              SubjectRef("user", u)) for t, u in new_t]))]:
        raise AssertionError("(c): the swapped generation's answers differ "
                             "from force_rebuild()'s")
    bad = sum(fresh._oracle.check(q.resource, q.permission, q.subject)
              != (swapped[1][i] == Permissionship.HAS_PERMISSION)
              for q, i in zip(q_reqs, pick))
    if bad:
        raise AssertionError(f"(c): {bad} answers differ from the oracle")
    log(f"offloop (c): {n_t} new tenants on a {t_pool}-row pool: "
        f"{d['stale_pair_marks']} pairs quarantined, {n_routed} pod#view "
        f"checks routed to the oracle in {t_routed:.4f} s while the candidate "
        f"was held; a {LOOKUP_LANES}-lane group#member lookup on the kernel "
        f"meanwhile {t_outside:.4f} s; after the swap ({d['bg_rebuilds']} "
        f"background installs) no pair is quarantined, the card's tables "
        f"equal the host's, and the answers equal force_rebuild()'s and "
        f"{len(q_reqs)} oracle checks")

    # (d) launches from zero over one background swap, writes replayed
    fresh.wait_rebuilds()
    fresh.prewarm_rebuilds = True
    gate, reached = threading.Event(), threading.Event()
    restore = _hold(fresh, "_prewarm_graph", gate, reached, before=False)
    kernels.reset_launches()
    f0 = fresh.stats["delta_batches"]
    try:
        with fresh._lock:
            fresh._kick_background_rebuild("background")
        if not reached.wait(timeout=600):
            raise AssertionError("(d): the candidate never prewarmed")
        create_pods(fresh, "q15d", 64)
    finally:
        gate.set()
        restore()
    if not fresh.wait_rebuilds(timeout=600):
        raise AssertionError("(d): the background rebuild did not finish")
    fresh.prewarm_rebuilds = False
    launches = dict(kernels.LAUNCHES)
    need = READ_KERNELS + ("scatter_rows",)
    # (CPU twins count no launches: on the CPU this checks nothing)
    idle = [k for k in need if on_card and not launches[k]]
    if idle or fresh.stats["delta_batches"] != f0:
        raise AssertionError(f"(d): kernels the candidate never launched: "
                             f"{idle}")
    _tables_match(fresh.graph())
    log(f"offloop (d): launches over one background swap (prewarm + replay "
        f"of 64 pod creates at the install), counted from zero after "
        f"wait_rebuilds(): { {k: v for k, v in launches.items() if v} }")
    _switch(False)
    del fresh
    gc.collect()
    log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "runs": runs}


# -- phase 16, the proxy's read path ------------------------------------------


def _seed_proxy_kube(n_namespaces: int, n_pods: int, n_events: int):
    """The fake kube-apiserver of phase 16: namespaces ns0.., pods
    ns{p % n}/p{p} and events ns{e % n}/ev{e}."""
    from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
        FakeKubeApiServer)
    kube = FakeKubeApiServer()
    for n in range(n_namespaces):
        kube.seed("", "v1", "namespaces", {"metadata": {"name": f"ns{n}"}})
    for p in range(n_pods):
        kube.seed("", "v1", "pods", {"metadata": {
            "name": f"p{p}", "namespace": f"ns{p % n_namespaces}"}})
    for e in range(n_events):
        kube.seed("", "v1", "events", {"metadata": {
            "name": f"ev{e}", "namespace": f"ns{e % n_namespaces}"}})
    return kube


def _oracle_pods(oracle, pods: list, subject) -> set:
    """The oracle's answer for `subject` over `pods` ("ns/name" ids):
    its check of each, one memo shared by all, as its own
    lookup_resources shares one over every candidate."""
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.evaluator import YES, _Ctx
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import ObjectRef
    ctx = _Ctx()
    return {p for p in pods
            if oracle._check(ObjectRef("pod", p), "view", subject, 0,
                             ctx) == YES}


def proxy_path(w, smi_line: str, device: str = "cuda") -> dict:
    """Phase 16: the proxy's read path on the card.  `ProxyServer(Options(
    spicedb_endpoint="torch://"))` over multitenant-1m (`w`, loaded into
    the server's own batched endpoint and warm-started with the prewarm),
    a fake kube-apiserver holding PROXY_NAMESPACES namespaces, PROXY_PODS
    pods and PROXY_EVENTS events, and deploy/rules.yaml's read rules
    (PROXY_READ_RULES).  Every request goes through
    `get_embedded_client(user=...)`: (a) PROXY_LIST_USERS concurrent
    `GET /api/v1/pods`, one a user (BASELINE config 5 through the proxy);
    (b) PROXY_GETS pod gets over fixed-seed (user, pod) pairs, half of
    them on pods the user may see, in waves of 100 concurrent; (c) one
    `GET /api/v1/events` postfilter list; (d) one protobuf and one Table
    list; (e) the e2e tests' watch scenario (grant then event: delivered;
    an unauthorized event: buffered; a late grant: flushed) on one
    namespace.  Checks: each list equals the seeded pods intersected with
    the bare TorchEndpoint's lookup for its user, and PROXY_ORACLE_USERS
    of them the oracle's answer; every get's status the oracle's check;
    the events the oracle's namespace checks; the protobuf and Table
    lists the JSON list's names; no read routed to the oracle
    (`stale_routed` 0); every READ_KERNELS kernel launched by these
    requests (counted from zero after the warm start, and read as the
    traffic ends; the traffic must rebuild nothing, so no background
    rebuild adds launches of its own).  Logged: (a)'s per-request
    p50/p99/max and wall; per request, the proxy's own time (request less
    upstream), the upstream round trip, the prefilter and the largest
    wait on it against PREFILTER_TIMEOUT; one direct 256-lane
    `lookup_resources_batch` of the same users on the same endpoint
    beside them and the proxy's summed phase seconds; (b)'s p50/p99; the
    launches; the card's memory."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.authz.responsefilterer import (
        PREFILTER_TIMEOUT)
    from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)
    from spicedb_kubeapi_proxy_tpu_torch.proxy import k8sproto
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        HandlerTransport)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import (
        Options, ProxyServer)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)
    from spicedb_kubeapi_proxy_tpu_torch.utils import tracing
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import REGISTRY

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    _switch(True)   # the port's default rebuild path
    rng = np.random.default_rng(SEED + 16)
    kube = _seed_proxy_kube(PROXY_NAMESPACES, PROXY_PODS, PROXY_EVENTS)
    seeded = [f"ns{p % PROXY_NAMESPACES}/p{p}" for p in range(PROXY_PODS)]
    seeded_set = set(seeded)
    rules = [proxyrule.parse_doc(d) for d in PROXY_READ_RULES]
    t0 = time.perf_counter()
    url = "torch://" if on_card else f"torch://?device={device}"
    proxy = ProxyServer(Options(
        spicedb_endpoint=url, rule_configs=rules,
        bootstrap=Bootstrap(w.schema_text, "\n".join(w.relationships)),
        upstream_transport=HandlerTransport(kube), prewarm_compiles=True))
    t1 = time.perf_counter()
    asyncio.run(proxy.warm_start())
    t2 = time.perf_counter()
    ep = proxy.endpoint
    chain = []
    while ep is not None:
        chain.append(type(ep).__name__)
        if isinstance(ep, TorchEndpoint):
            break
        ep = getattr(ep, "inner", None)
    if chain != ["InstrumentedEndpoint", "BatchingEndpoint", "TorchEndpoint"]:
        raise AssertionError(f"proxy endpoint chain {chain}")
    if ep.device.type != torch.device(device).type:
        raise AssertionError(f"proxy endpoint on {ep.device}, not {device}")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"phase 16: {len(w.relationships)} tuples into ProxyServer({url!r}) "
        f"in {t1 - t0:.3f} s, warm start with prewarm {t2 - t1:.3f} s; "
        f"chain {' > '.join(chain)}; kube {PROXY_NAMESPACES} namespaces, "
        f"{PROXY_PODS} pods, {PROXY_EVENTS} events")

    users = [f"u{i}" for i in range(PROXY_LIST_USERS)]
    subjects = [SubjectRef("user", u) for u in users]
    gets_rng = [(users[int(i)], seeded[int(p)]) for i, p in zip(
        rng.integers(0, len(users), PROXY_GETS),
        rng.integers(0, len(seeded), PROXY_GETS))]

    def phase_sums() -> dict:
        h = REGISTRY.get("authz_request_phase_seconds")
        return {k[0]: v[1] for k, v in h.raw().items()} if h else {}

    async def timed_get(user, target, accept=None):
        client = proxy.get_embedded_client(user=user)
        t = time.perf_counter()
        resp = await client.get(target, headers=[("Accept", accept)]
                                if accept else None)
        return resp, time.perf_counter() - t

    def names_of(resp) -> set:
        if resp.status != 200:
            raise AssertionError(f"list answered {resp.status}: "
                                 f"{resp.body[:300]!r}")
        return {f"{i['metadata']['namespace']}/{i['metadata']['name']}"
                for i in json.loads(resp.body)["items"]}

    out = {}

    def span_s(trace: dict, name: str) -> float:
        return sum(sp["duration_ms"] for sp in trace["spans"]
                   if sp["name"] == name) / 1e3

    def span_start(trace: dict, name: str) -> float:
        return min(sp["start_ms"] for sp in trace["spans"]
                   if sp["name"] == name) / 1e3

    def span_end(trace: dict, name: str) -> float:
        return max(sp["start_ms"] + sp["duration_ms"]
                   for sp in trace["spans"] if sp["name"] == name) / 1e3

    async def traffic():
        # (a) the concurrent lists.  The server records every finished
        # request's trace; a recorder that holds all of them gives each
        # request's upstream time and prefilter wait by its trace id
        sums0 = phase_sums()
        recorder = tracing.RECORDER
        tracing.RECORDER = tracing.SlowTraceRecorder(capacity=2 * len(users))
        try:
            t_a = time.perf_counter()
            res = await asyncio.gather(*(timed_get(u, "/api/v1/pods")
                                         for u in users))
            out["a_wall"] = time.perf_counter() - t_a
            traces = {t["trace_id"]: t for t in tracing.RECORDER.snapshot()}
        finally:
            tracing.RECORDER = recorder
        out["a_lat"] = [s for _, s in res]
        out["a_lists"] = [names_of(r) for r, _ in res]
        sums1 = phase_sums()
        out["a_phases"] = {k: sums1[k] - sums0.get(k, 0.0) for k in sums1}
        a_traces = [traces[r.headers.get(tracing.TRACE_ID_HEADER)]
                    for r, _ in res]
        # the proxy's own time is the request's less its upstream round
        # trip, in which the fake apiserver encodes each list under its
        # lock, one list at a time; the prefilter runs beside the upstream
        out["a_upstream"] = [span_s(t, "upstream") for t in a_traces]
        out["a_own"] = [t["duration_ms"] / 1e3 - u
                        for t, u in zip(a_traces, out["a_upstream"])]
        out["a_wait"] = [span_s(t, "respfilter.wait") for t in a_traces]
        # what the pre-filter timeout measures: how long after a request
        # began to wait its prefilter ended (its resume may then queue
        # behind other requests' filtering on the loop, which the
        # timeout does not count)
        out["a_late"] = [max(0.0, span_end(t, "prefilter")
                             - span_start(t, "respfilter.wait"))
                         for t in a_traces]
        out["a_prefilter"] = [span_s(t, "prefilter") for t in a_traces]
        # (b) the gets: half on pods the user's list holds
        pairs = []
        for k in range(PROXY_GETS):
            i = k % len(users)
            mine = sorted(out["a_lists"][i])
            if k % 2 == 0 and mine:
                pairs.append((users[i], mine[int(rng.integers(len(mine)))]))
            else:
                pairs.append(gets_rng[k])
        out["b_pairs"] = pairs
        out["b_status"], out["b_lat"] = [], []
        for w0 in range(0, len(pairs), 100):
            res = await asyncio.gather(*(
                timed_get(u, "/api/v1/namespaces/{}/pods/{}".format(
                    *p.split("/"))) for u, p in pairs[w0: w0 + 100]))
            out["b_status"] += [r.status for r, _ in res]
            out["b_lat"] += [s for _, s in res]
        # (c) the postfilter list
        resp, out["c_s"] = await timed_get(users[0], "/api/v1/events")
        out["c_names"] = names_of(resp)
        # (d) protobuf and Table lists of the same user
        resp, out["d_proto_s"] = await timed_get(
            users[0], "/api/v1/pods", "application/vnd.kubernetes.protobuf")
        _, kind, raw, _ = k8sproto.decode_unknown(resp.body)
        out["d_proto"] = {"/".join(k8sproto.object_meta(i))
                          for i in k8sproto.iter_list_items(raw)}
        resp, out["d_table_s"] = await timed_get(
            users[0], "/api/v1/pods",
            "application/json;as=Table;v=v1;g=meta.k8s.io")
        out["d_table"] = {"{namespace}/{name}".format(
            **r["object"]["metadata"]) for r in json.loads(resp.body)["rows"]}
        # (e) the watch scenario on one namespace
        out["e"] = await watch_scenario()

    async def watch_scenario() -> list:
        ns = "ns0"
        client = proxy.get_embedded_client(user=users[0])
        resp = await client.get(f"/api/v1/namespaces/{ns}/pods?watch=true")
        if resp.status != 200 or resp.stream is None:
            raise AssertionError(f"watch answered {resp.status}")
        frames: asyncio.Queue = asyncio.Queue()

        async def consume():
            async for frame in resp.stream:
                await frames.put(json.loads(frame))

        task = asyncio.ensure_future(consume())
        key = ("", "v1", "pods")
        seen = []
        try:
            await proxy.endpoint.write_relationships([RelationshipUpdate(
                UpdateOp.TOUCH, parse_relationship(
                    f"pod:{ns}/pwatch#creator@user:{users[0]}"))])
            await asyncio.sleep(0.6)  # let the store watch propagate
            kube.seed("", "v1", "pods", {"metadata": {
                "name": "pwatch", "namespace": ns}})
            await kube._notify(key, "ADDED", kube.objects[key][ns]["pwatch"])
            seen.append((await asyncio.wait_for(frames.get(), 10))
                        ["object"]["metadata"]["name"])
            kube.seed("", "v1", "pods", {"metadata": {
                "name": "phidden", "namespace": ns}})
            await kube._notify(key, "ADDED",
                               kube.objects[key][ns]["phidden"])
            try:
                ev = await asyncio.wait_for(frames.get(), 0.7)
                seen.append(ev["object"]["metadata"]["name"])
            except asyncio.TimeoutError:
                seen.append("buffered")
            await proxy.endpoint.write_relationships([RelationshipUpdate(
                UpdateOp.TOUCH, parse_relationship(
                    f"pod:{ns}/phidden#creator@user:{users[0]}"))])
            seen.append((await asyncio.wait_for(frames.get(), 10))
                        ["object"]["metadata"]["name"])
        finally:
            task.cancel()
        return seen

    rebuild_keys = ("rebuilds", "bg_rebuilds", "preemptive_rebuilds",
                    "rebuild_failures")
    rebuilds0 = {k: ep.stats[k] for k in rebuild_keys}
    kernels.reset_launches()
    t3 = time.perf_counter()
    asyncio.run(traffic())
    t4 = time.perf_counter()
    launches = {k: kernels.LAUNCHES[k] for k in REPLACES}
    # a rebuild kicked by the watch scenario's writes would launch kernels
    # of its own in the background: the counts above hold only requests
    ep.wait_rebuilds()
    rebuilds1 = {k: ep.stats[k] for k in rebuild_keys}
    if rebuilds1 != rebuilds0:
        raise AssertionError(f"the traffic rebuilt the graph ({rebuilds0} "
                             f"-> {rebuilds1}): its launches are not all "
                             f"the requests'")
    mem = ((torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated(),
            torch.cuda.memory_reserved()) if on_card else (0, 0, 0))

    # the direct batch beside (a): the same users, the same endpoint
    direct_s = []
    for _ in range(2):
        t = time.perf_counter()
        asyncio.run(proxy.endpoint.lookup_resources_batch(
            "pod", "view", subjects))
        direct_s.append(time.perf_counter() - t)
    bare = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))

    # correctness
    for u, got, ids in zip(users, out["a_lists"], bare):
        want = seeded_set & set(ids)
        if got != want:
            raise AssertionError(f"{u}'s list differs from the endpoint's "
                                 f"lookup ({len(got)} vs {len(want)})")
    oracle = ep._oracle
    t5 = time.perf_counter()
    for i in rng.choice(len(users), PROXY_ORACLE_USERS, replace=False):
        want = _oracle_pods(oracle, seeded, subjects[i])
        if out["a_lists"][i] != want:
            raise AssertionError(f"{users[i]}'s list differs from the "
                                 f"oracle ({len(out['a_lists'][i])} vs "
                                 f"{len(want)})")
    t6 = time.perf_counter()
    for (u, p), status in zip(out["b_pairs"], out["b_status"]):
        ok = oracle.check(ObjectRef("pod", p), "view", SubjectRef("user", u))
        if status != (200 if ok else 403):
            raise AssertionError(f"get of {p} by {u} answered {status}, "
                                 f"oracle {ok}")
    want_events = {f"ns{e % PROXY_NAMESPACES}/ev{e}"
                   for e in range(PROXY_EVENTS)
                   if oracle.check(ObjectRef(
                       "namespace", f"ns{e % PROXY_NAMESPACES}"), "view",
                       subjects[0])}
    if out["c_names"] != want_events:
        raise AssertionError(f"events list {len(out['c_names'])} differs "
                             f"from the oracle's {len(want_events)}")
    if not (out["d_proto"] == out["d_table"] == out["a_lists"][0]):
        raise AssertionError("protobuf / Table lists differ from the JSON "
                             "list")
    if out["e"] != ["pwatch", "buffered", "phidden"]:
        raise AssertionError(f"watch scenario saw {out['e']}")
    stale = ep.stats["stale_routed"]
    if stale:
        raise AssertionError(f"{stale} reads routed to the oracle")
    idle = [k for k in READ_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the proxy's "
                             f"requests: {idle}")
    n_allowed = sum(s == 200 for s in out["b_status"])
    sizes = [len(x) for x in out["a_lists"]]
    log(f"phase 16 (a) {len(users)} concurrent lists: wall "
        f"{out['a_wall']:.4f} s; per request {_pcts(out['a_lat'])}, max "
        f"{max(out['a_lat']) * 1e3:.3f} ms; items per list min "
        f"{min(sizes)} median {int(np.median(sizes))} max {max(sizes)} "
        f"({smi_line})")
    late_max = max(out["a_late"])
    log(f"phase 16 (a) per request, the proxy's own time (request less "
        f"upstream): {_pcts(out['a_own'])}, max "
        f"{max(out['a_own']) * 1e3:.3f} ms; upstream (the fake apiserver): "
        f"{_pcts(out['a_upstream'])}, max "
        f"{max(out['a_upstream']) * 1e3:.3f} ms; prefilter "
        f"{_pcts(out['a_prefilter'])}, max "
        f"{max(out['a_prefilter']) * 1e3:.3f} ms; respfilter.wait "
        f"{_pcts(out['a_wait'])}, max {max(out['a_wait']) * 1e3:.3f} ms; "
        f"latest prefilter end after its wait began "
        f"{late_max * 1e3:.3f} ms, {PREFILTER_TIMEOUT - late_max:.3f} s "
        f"under the {PREFILTER_TIMEOUT:.0f} s pre-filter timeout "
        f"({smi_line})")
    log(f"phase 16 (a) direct {len(users)}-lane lookup_resources_batch on "
        f"the same endpoint: {', '.join(f'{s:.4f}' for s in direct_s)} s; proxy "
        f"phase seconds summed over the burst: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            out["a_phases"].items())))
    log(f"phase 16 (b) {len(out['b_status'])} gets ({n_allowed} allowed) in "
        f"waves of 100: {_pcts(out['b_lat'])}; (c) events list "
        f"{out['c_s'] * 1e3:.3f} ms ({len(out['c_names'])} of "
        f"{PROXY_EVENTS} kept); (d) protobuf {out['d_proto_s'] * 1e3:.3f} "
        f"ms, Table {out['d_table_s'] * 1e3:.3f} ms, "
        f"{len(out['d_proto'])} items each; (e) watch {out['e']}")
    log(f"phase 16 launches by the proxy's requests: "
        f"{ {k: v for k, v in launches.items() if v} }; stale_routed "
        f"{stale}; card memory allocated {mem[0] / 2**20:.1f} MiB, peak "
        f"{mem[1] / 2**20:.1f} MiB, reserved {mem[2] / 2**20:.1f} MiB; "
        f"traffic {t4 - t3:.1f} s; oracle on {PROXY_ORACLE_USERS} users "
        f"{t6 - t5:.1f} s")
    # the watch scenario gave users[0] its two new pods
    socket = _proxy_socket(proxy, users[0], out["a_lists"][0]
                           | {"ns0/pwatch", "ns0/phidden"})
    log(f"phase 16 loopback: {socket}")
    log(f"phase 16 wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


def _proxy_socket(proxy, user: str, want: set) -> str:
    """One (a)-style list over a loopback socket (`start(port=0)` and
    `H11Transport`), when h11 is importable."""
    try:
        import h11  # noqa: F401
    except ImportError:
        return "skipped (h11 is not installed)"
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        H11Transport, Headers, Request)

    async def go():
        port = await proxy.start(port=0)
        try:
            t = time.perf_counter()
            resp = await H11Transport(f"http://127.0.0.1:{port}").round_trip(
                Request("GET", "/api/v1/pods", headers=Headers([
                    ("X-Remote-User", user), ("Accept", "application/json")])))
            return resp, time.perf_counter() - t
        finally:
            await proxy.stop()

    resp, secs = asyncio.run(go())
    got = {f"{i['metadata']['namespace']}/{i['metadata']['name']}"
           for i in json.loads(resp.body)["items"]}
    if resp.status != 200 or got != want:
        raise AssertionError(f"loopback list answered {resp.status} with "
                             f"{len(got)} items, want {len(want)}")
    return f"list of {len(got)} items in {secs * 1e3:.3f} ms"


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import _sweep_bytes
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)

    # 1. card identity
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    peak = hbm_peak(name)
    log(f"device: {name} ({torch.cuda.device_count()} visible); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi_line)

    # 2. build
    t0 = time.perf_counter()
    path = kernels.build()
    kernels._load()
    log(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log("  " + line.strip())

    # phases 1-14 assert that their churn rebuilds nothing: they run with
    # the off-loop rebuild switch off; phase 15 and the swaps after 13a and
    # 10 turn it on where they need it
    _switch(False)

    # 3. load
    phase_s = {}
    t_ph = time.perf_counter()
    timer = Timer(torch, torch.device("cuda"))
    ep, w = load("cuda", {})
    mt_statuses = ep._leopard.status_map()
    log(f"Leopard statuses at multitenant-1m: {mt_statuses}")
    phase_s["1-3"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()

    # 4-5. the main path, launches counted from zero
    kernels.reset_launches()
    batches, lookups, reqs, checks, summary = drive(ep, w, timer)
    launches = {k: kernels.LAUNCHES[k] for k in READ_KERNELS}
    log(f"launches on the main path: {launches}; sweep graphs "
        f"{ep.graph().kernel.graph_stats}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")

    # 6. kernels against twins, timings and bounds
    rows, per, nt = kernels_vs_twins(ep, batches, reqs, timer, peak)
    for r in rows.values():
        r["launches"] = launches[r["name"]]

    # 7. answers against the oracle
    oracle_check(ep, batches, lookups, reqs, checks)

    # 8. byte model and bound at this card's peak
    g = ep.graph()
    model = _sweep_bytes(g, LOOKUP_LANES)
    sweep_ms = (per["ell_gather_or"][0] + per["perm_program"][0]
                + rows["sweep_delta"]["ms"])
    log(f"sweep byte model (reference _sweep_bytes): {model} bytes per sweep "
        f"at {LOOKUP_LANES} lanes; bound {model / peak * 1e3:.6f} ms at "
        f"{peak / 1e12:.2f} TB/s ({smi_line}); measured sweep "
        f"kernels {sweep_ms:.6f} ms -> {model / peak * 1e3 / sweep_ms:.4f} "
        f"of the bound")
    for verb in ("lookup", "check"):
        s = summary[verb]
        log(f"{verb} summary: warm median e2e "
            f"{statistics.median(s['e2e_s'][1:]):.6f} s, sweeps "
            f"{s['sweeps'][-1]}")

    phase_s["4-8"] = time.perf_counter() - t_ph

    # 9. the write path, launches counted from zero over the churn
    t_ph = time.perf_counter()
    rows["scatter_rows"] = churn(
        ep, w, timer, peak,
        statistics.median(summary["lookup"]["e2e_s"][1:]))
    phase_s["9"] = time.perf_counter() - t_ph

    # 11. the segment kernel on the same store, beside the ELL endpoint
    t_ph = time.perf_counter()
    seg_rows, _, seg = segment_path(ep, w, timer, peak, smi_line)
    phase_s["11"] = time.perf_counter() - t_ph

    # 13a-b. the mesh path on the same store: the sharded ELL endpoint
    # against the single-device one, then ShardedKernel against the
    # segment endpoint
    t_ph = time.perf_counter()
    mesh = make_smoke_mesh("cuda")
    m_ep, mesh_mt = mesh_multitenant(ep, w, mesh, timer, peak, smi_line)
    swap_and_agree(m_ep, ep, "pod", "view", batches[0], reqs,
                   "phase 13a mesh endpoint")
    del m_ep
    gc.collect()
    mesh_seg = mesh_segment(seg, mesh, timer, peak)
    phase_s["13a-b"] = time.perf_counter() - t_ph

    # 14. batched dispatch on the phase-3 endpoint, launches counted from 0
    t_ph = time.perf_counter()
    batched_dispatch(ep, w, smi_line)
    phase_s["14"] = time.perf_counter() - t_ph

    # 15. off-loop rebuilds on the same store
    t_ph = time.perf_counter()
    offloop = offloop_rebuild(ep, w, batches, reqs, smi_line)
    phase_s["15"] = time.perf_counter() - t_ph

    # 10. the caveated deployment on its own endpoint (the first one goes),
    # then 13c, the same store on a mesh endpoint
    t_ph = time.perf_counter()
    del ep, g, batches, lookups, reqs, checks, seg
    gc.collect()
    torch.cuda.empty_cache()
    cav_rows, cav_ep, cav_w, _ = caveats(timer, peak, smi_line)
    phase_s["10"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    mesh_cav = mesh_caveats(cav_ep, cav_w, mesh, timer, peak)
    cav_pods = [p for p in cav_ep.graph().prog.object_ids[
        cav_w.resource_type] if "\x00" not in p][:40]
    cav_subjects = [SubjectRef("user", u) for u in cav_w.subjects[:50]]
    swap_and_agree(cav_ep, cav_ep, cav_w.resource_type, cav_w.permission,
                   cav_subjects, [CheckRequest(ObjectRef(
                       cav_w.resource_type, p), cav_w.permission, s)
                       for p in cav_pods for s in cav_subjects],
                   "phase 10 caveated endpoint")
    del cav_ep, cav_w
    phase_s["13c"] = time.perf_counter() - t_ph

    # 12. the Leopard index at group-explosion, indexed against not, then
    # 13d, its store on a mesh endpoint with the index on
    t_ph = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    leo_rows, leo_a, leo_w = leopard_path(timer, peak, smi_line,
                                          mt_statuses)
    phase_s["12"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    mesh_leo = mesh_leopard(leo_a, leo_w, mesh, timer)
    del leo_a, leo_w
    phase_s["13d"] = time.perf_counter() - t_ph

    # 16. the proxy's read path over multitenant-1m on its own endpoint
    t_ph = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    proxy = proxy_path(w, smi_line)
    phase_s["16"] = time.perf_counter() - t_ph
    for kname, r in cav_rows.items():
        if kname in rows:
            # a kernel of both paths: its plane-mode numbers beside the
            # definite ones
            rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"],
                                             r["max_abs_err"])
            rows[kname].update({f"planes_{k}": v for k, v in r.items()
                                if k != "max_abs_err"})
        else:
            rows[kname] = {"name": kname, "route": "cuda",
                           "source": KERNEL_SOURCE,
                           "replaces": REPLACES[kname], **r}
    # the segment path's and the plane reads' numbers: new kernels get
    # their row, shared ones the numbers beside their own (prefixed)
    for prefix, extra in (("segment", seg_rows), ("leopard", leo_rows)):
        for kname, r in extra.items():
            if kname in rows:
                rows[kname]["max_abs_err"] = max(
                    rows[kname]["max_abs_err"], r.get("max_abs_err", 0))
                rows[kname].update({f"{prefix}_{k}": v for k, v in r.items()
                                    if k != "max_abs_err"})
            else:
                rows[kname] = {"name": kname, "route": "cuda",
                               "source": KERNEL_SOURCE,
                               "replaces": REPLACES[kname], **r}
    # the mesh path (phase 13): or_combine's row, and every kernel's
    # launches on its read batches beside the single-device ones
    rows["or_combine"] = {"name": "or_combine", "route": "cuda",
                          "source": KERNEL_SOURCE,
                          "replaces": REPLACES["or_combine"],
                          **mesh_seg["rows"]["or_combine"]}
    # the sharded sweep's kernels: numbers and launches of phase 13a (13c
    # for the caveat gather), the caveated deployment's beside them
    for kname in MESH_SWEEP_KERNELS + ("mesh_cav_gather_or",):
        mt = mesh_mt["sweep"]["rows"].get(kname)
        cav = mesh_cav["sweep"]["rows"][kname]
        r = dict(mt) if mt is not None else dict(cav)
        r["launches"] = (mesh_mt if mt is not None else
                         mesh_cav)["launches"][kname]
        if mt is not None:
            r["max_abs_err"] = max(r["max_abs_err"], cav["max_abs_err"])
            r.update({f"planes_{k}": v for k, v in cav.items()
                      if k != "max_abs_err"})
        rows[kname] = {"name": kname, "route": "cuda",
                       "source": KERNEL_SOURCE, "replaces": REPLACES[kname],
                       **r}
    for kname in rows:
        rows[kname]["mesh_launches"] = {
            "multitenant": mesh_mt["launches"].get(kname, 0),
            "segment": mesh_seg["launches"].get(kname, 0),
            "caveats": mesh_cav["launches"].get(kname, 0),
            "leopard": mesh_leo["launches"].get(kname, 0)}
    rows["scatter_rows"].update({f"mesh_flush_{k}": v for k, v in
                                 mesh_mt["scatter"].items()})
    # phase 15 (d): one background swap's launches, counted from zero
    for kname in rows:
        rows[kname]["offloop_launches"] = offloop["launches"].get(kname, 0)
    # phase 16: the proxied requests' launches, counted from zero
    for kname in rows:
        rows[kname]["proxy_launches"] = proxy["launches"].get(kname, 0)
    for kname, also in REPLACES_ALSO.items():
        rows[kname]["replaces_also"] = also
    log("phase seconds: " + ", ".join(f"{k}: {v:.1f}"
                                      for k, v in phase_s.items()))
    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
