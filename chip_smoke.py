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
   lookup batch re-run on the CPU twins (state, trace and words equal);
7. answers against the host oracle on a fixed-seed sample (4 full
   lookups, 2,000 checks);
8. the sweep byte model and the bound it implies at this card's peak;
9. the write path on the same endpoint: 16 rounds of churn (64 pod
   creates on spare rows, 32 pod deletes that reclaim them, 16 hub-group
   touches and 8 deletes, 2 grants that grow a full namespace row), each
   followed by a 256-lane lookup batch and a 10,000-pair check batch that
   read the round's writes; every kernel, `scatter_rows` included, must
   have launched during the rounds.  No rebuild may happen; after every flush
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
   equal the CPU twins'; a sample of checks (CONDITIONAL ones included)
   and one lookup must equal the host oracle's; then 8 rounds of caveat
   churn (new undecidable memberships, re-touches that flip decidability,
   deletes, caveated tuples made definite) must be absorbed without a
   rebuild, leave the card's tables equal to the host's after each
   flush, and answer as `force_rebuild()` and the oracle do.  Every kernel
   of the caveat path (all but the definite `check_gather`) must have
   launched during phase 10.

Any failed phase raises and the script exits non-zero.  The second-to-
last line is the kernel table as JSON, the last line
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
}
# the kernels of the definite read path (phases 4-5) and of the caveat
# path (phase 10: definite checks are check_gather3's there)
READ_KERNELS = ("ell_gather_or", "perm_program", "sweep_delta",
                "seed_bitplanes", "check_gather", "lookup_T")
CAVEAT_KERNELS = tuple(k for k in REPLACES if k != "check_gather")
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
    url = "torch://" if device == "cuda" else f"torch://?device={device}"
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
    steps = list(kc.sweep_steps(main, aux))
    err = {"ell_gather_or": 0, "perm_program": 0, "sweep_delta": 0}
    x = x0.clone()
    for _ in range(2):
        cur_k, cur_t = x.clone(), x.clone()
        for step in steps:
            EllKernelCache.run_step(step, cur_k, x0, live, kernels)
            EllKernelCache.run_step(step, cur_t, x0, live, reference)
            err[step[0]] = max(err[step[0]], _diff(cur_k, cur_t))
            if err[step[0]]:
                raise AssertionError(f"{step[0]} differs from its twin at "
                                     f"step {steps.index(step)}")
        d_k = kernels.sweep_delta(cur_k, x, dead)
        d_t = reference.sweep_delta(cur_t, x, dead)
        err["sweep_delta"] = max(err["sweep_delta"], _diff(d_k.cpu(), d_t)
                                 + _diff(cur_k, cur_t))
        x = cur_k
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
            _, idx, _, seeded, wcb = step
            n, k = idx.shape
            uniq = int(torch.unique(idx).numel())
            acc[2] += (n * k * 4 + uniq * word + n * word * (1 + seeded)
                       + (n * 4 + word * live.shape[0] if wcb is not None
                          else 0))
            acc[3] += n * n_words * (k + seeded)
        else:
            _, code, _, length, _, _ = step
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
    return rows, per, nt


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


def _churn_plan(w, n_rounds: int, seed: int) -> list:
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
            pod = f"ns{k}/w{r}-{i}"
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
        t0 = time.perf_counter()
        asyncio.run(commit(rnd["writes"]))
        t_write = time.perf_counter() - t0
        res, t_lookup = lookup(subjects)
        graph = ep.graph()
        tables_match(graph)
        apply_ms = (ep.stats["delta_apply_s"] - a0) * 1e3
        flush_ms = (ep.stats["flush_s"] - f0) * 1e3
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
                       "check_s": t_check,
                       "sweeps": int(graph.last_trace[0])})
        log(f"churn round {r}: {sum(len(x) for x in rnd['writes'])} updates "
            f"in {len(rnd['writes'])} writes {t_write * 1e3:.3f} ms; delta "
            f"application {apply_ms:.3f} ms, flush {flush_ms:.3f} ms (host); "
            f"read-after-write lookup batch {t_lookup:.4f} s, check batch "
            f"{t_check:.4f} s; device tables equal host")
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
        f"{med('apply_ms'):.3f} ms, flush {med('flush_ms'):.3f} ms (host); "
        f"read-after-write lookup batch median {med('lookup_s'):.4f} s vs "
        f"phase-4 warm median {warm_lookup_s:.4f} s; check batch median "
        f"{med('check_s'):.4f} s")

    # scatter_rows on the last round's real rows, against its twin, and
    # its times: main and aux table per flush
    last_lookup = [sorted(x) for x in res]
    last_checks = [c.allowed for c in checks]
    out_row = {"name": "scatter_rows", "route": "cuda",
               "source": KERNEL_SOURCE, "replaces": REPLACES["scatter_rows"],
               "launches": launches["scatter_rows"]}
    err, ms, plain, lib, nbytes, dims = 0, 0.0, 0.0, 0.0, 0, []
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
            workload_kwargs: Optional[dict] = None) -> dict:
    """Phase 10: the caveated deployment on a second endpoint.  Returns
    {kernel name: measurements on the caveat path}."""
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
    steps = list(kc.sweep_steps(main, aux, cav, n_words))
    err = {"ell_gather_or": 0, "cav_gather_or": 0, "perm_program": 0,
           "sweep_delta": 0}
    x = x0.clone()
    for _ in range(2):
        cur_k, cur_t = x.clone(), x.clone()
        for i, step in enumerate(steps):
            EllKernelCache.run_step(step, cur_k, x0, live, kernels, x_in=x)
            EllKernelCache.run_step(step, cur_t, x0, live, reference, x_in=x)
            err[step[0]] = max(err[step[0]], _diff(cur_k, cur_t))
            if err[step[0]]:
                raise AssertionError(f"{step[0]} differs from its twin at "
                                     f"Jacobi step {i}")
        d_k = kernels.sweep_delta(cur_k, x, dead)
        d_t = reference.sweep_delta(cur_t, x, dead)
        err["sweep_delta"] = max(err["sweep_delta"],
                                 _diff(d_k.cpu(), d_t) + _diff(cur_k, cur_t))
        x = cur_k
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
            _, idx, _, seeded, wcb = step
            n, k = idx.shape
            uniq = int(torch.unique(idx).numel())
            acc[2] += (n * k * 4 + uniq * word + n * word * (1 + seeded)
                       + (n * 4 + word * live.shape[0] if wcb is not None
                          else 0))
            acc[3] += n * width * (k + seeded)
        elif name == "cav_gather_or":
            _, idx, half = step
            r_, k = idx.shape
            uniq = int(torch.unique(idx).numel())
            reached = int((idx != dead).any(dim=1).sum())
            acc[2] += r_ * k * 4 + (uniq + 2 * reached) * 4 * half
            acc[3] += r_ * half * k
        else:
            _, code, _, length, _, _ = step
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
        t0 = time.perf_counter()
        res = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        timer.sync()
        t_lookup = time.perf_counter() - t0
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
                       "lookup_s": t_lookup, "check_s": t_check})
        log(f"caveat churn round {r}: {len(rnd['writes'])} writes "
            f"{t_write * 1e3:.3f} ms; delta application "
            f"{rounds[-1]['apply_ms']:.3f} ms, flush "
            f"{rounds[-1]['flush_ms']:.3f} ms (host); read-after-write "
            f"lookup batch {t_lookup:.4f} s, check batch {t_check:.4f} s "
            f"(sweeps {int(g.last_trace[0])}, CONDITIONAL "
            f"{cres.count(1)}); device tables equal host")
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
    log(f"caveat write path summary: median per round delta application "
        f"{med('apply_ms'):.3f} ms, flush {med('flush_ms'):.3f} ms (host); "
        f"read-after-write lookup batch median {med('lookup_s'):.4f} s, check"
        f" batch median {med('check_s'):.4f} s")
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
    return rows


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

    # 3. load
    timer = Timer(torch, torch.device("cuda"))
    ep, w = load("cuda", {})

    # 4-5. the main path, launches counted from zero
    kernels.reset_launches()
    batches, lookups, reqs, checks, summary = drive(ep, w, timer)
    launches = {k: kernels.LAUNCHES[k] for k in READ_KERNELS}
    log(f"launches on the main path: {launches}")
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

    # 9. the write path, launches counted from zero over the churn
    rows["scatter_rows"] = churn(
        ep, w, timer, peak,
        statistics.median(summary["lookup"]["e2e_s"][1:]))

    # 10. the caveated deployment on its own endpoint (the first one goes)
    del ep, g, batches, lookups, reqs, checks
    gc.collect()
    torch.cuda.empty_cache()
    cav_rows = caveats(timer, peak, smi_line)
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
    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
