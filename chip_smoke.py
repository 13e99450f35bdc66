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
   a sample of the host oracle's.

Any failed phase raises and the script exits non-zero.  The second-to-
last line is the kernel table as JSON, the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import asyncio
import json
import os
import statistics
import subprocess
import sys
import time

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

KERNEL_SOURCE = "spicedb_kubeapi_proxy_tpu_torch/ops/kernels/csrc/ell_kernels.cu"
REPLACES = {
    "ell_gather_or": "spicedb_kubeapi_proxy_tpu/ops/ell.py:444",
    "perm_program": "spicedb_kubeapi_proxy_tpu/ops/ell.py:215",
    "sweep_delta": "spicedb_kubeapi_proxy_tpu/ops/ell.py:613",
    "seed_bitplanes": "spicedb_kubeapi_proxy_tpu/ops/ell.py:556",
    "check_gather": "spicedb_kubeapi_proxy_tpu/ops/ell.py:878",
    "lookup_T": "spicedb_kubeapi_proxy_tpu/ops/ell.py:889",
    "scatter_rows": "spicedb_kubeapi_proxy_tpu/ops/jax_endpoint.py:1004",
}
READ_KERNELS = tuple(k for k in REPLACES if k != "scatter_rows")
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


def load(device: str, workload_kwargs: dict):
    """Phase 3: generate, load and build; returns (endpoint, workload)."""
    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    t0 = time.perf_counter()
    w = workloads.multitenant_1m(**workload_kwargs)
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
        f"{g.kernel.aux_passes - 1}, {len(g.kernel.stages)} stages, "
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
    main, aux = g.snapshot()
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
            _, code, _, length, _ = step
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
    depth = kc.aux_passes - 1
    kc_cpu = EllKernelCache(prog, n_aux_rows=kc.n_aux_rows, tree_depth=depth,
                            device=cpu, shared_tree_depth=depth,
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

    def tables_match(graph):
        dm, da = graph.snapshot()
        if not (torch.equal(dm.cpu(), torch.from_numpy(graph.host_main))
                and torch.equal(da.cpu(), torch.from_numpy(graph.host_aux))):
            raise AssertionError("device tables differ from the host tables "
                                 "after the flush")

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
            snap = ep.graph().snapshot()
            iso = (iso_subj, before, ctx, snap, [t.clone() for t in snap])
        if r == n_rounds - 1:
            prev_tables = ep.graph().snapshot()
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
    idle = [k for k, v in launches.items() if v == 0]
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
    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
