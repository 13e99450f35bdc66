"""Delta-stream minimizer + self-contained repro artifacts, the port's
counterpart of the reference's fuzz/shrink.py.

A failing (case, gate-combo, role) cell shrinks in three passes, each
validated by a fresh full replay (`driver.run_case` in single-query
probe mode — the probe applies a candidate stream and evaluates ONLY
the diverging query at the end state):

1. **prefix truncation** — the stream is cut at the burst the
   divergence was first seen after (the divergence may heal later:
   later state is irrelevant);
2. **burst atomization** — multi-op write bursts split into one-op
   bursts so elimination works at single-delta granularity;
3. **backward elimination** — drop one burst at a time (then one
   bulk/init relationship at a time), keeping any removal that still
   reproduces, looping to a fixpoint under a probe budget.

The artifact a failing seed writes is a plain JSON file carrying the
schema text, the minimized init set + delta stream, the diverging
query, both answers, the revision, and the exact (gates, role, kernel)
cell — everything `replay_artifact` needs to reproduce the divergence
from nothing.  The format is the reference's (`ARTIFACT_VERSION` 1, the
same JSON fields, the device's answer under `jax_answer`), so an
artifact written by either package loads and replays in the other.
Probes and replays run on the `device` they are given (None: the CUDA
card).
"""

from __future__ import annotations

import json
import os

from . import metrics as fuzz_metrics
from .driver import Divergence, FuzzCase, run_case

ARTIFACT_VERSION = 1

DEFAULT_PROBE_BUDGET = 120


def _probe(case: FuzzCase, d: Divergence, device=None) -> bool:
    """Does this candidate stream still reproduce the divergence?"""
    fuzz_metrics.note_shrink_probe()
    got = run_case(case, gates=d.gates, role=d.role,
                   check_only=d.query, final_only=True,
                   record_metrics=False, device=device)
    return bool(got)


def _with(case: FuzzCase, init_rels=None, bursts=None) -> FuzzCase:
    return FuzzCase(seed=case.seed, schema_text=case.schema_text,
                    init_rels=case.init_rels if init_rels is None
                    else init_rels,
                    bursts=case.bursts if bursts is None else bursts,
                    targets=case.targets, subjects=case.subjects,
                    kernel=case.kernel, schema=case.schema)


def _atomize(bursts: list) -> list:
    out = []
    for b in bursts:
        if b["kind"] == "write" and len(b["ops"]) > 1:
            out.extend({"kind": "write", "ops": [op]} for op in b["ops"])
        else:
            out.append(b)
    return out


def delta_count(case: FuzzCase) -> int:
    """Store-mutating deltas in the case: init rels + write ops + bulk
    rels + one per delete_by_filter (clock advances are free)."""
    n = len(case.init_rels)
    for b in case.bursts:
        if b["kind"] == "write":
            n += len(b["ops"])
        elif b["kind"] == "bulk":
            n += len(b["rels"])
        elif b["kind"] == "dbf":
            n += 1
    return n


def shrink_case(case: FuzzCase, d: Divergence,
                probe_budget: int = DEFAULT_PROBE_BUDGET,
                device=None) -> FuzzCase:
    """Smallest-reproducing case for divergence `d` (best-effort under
    `probe_budget` replays; the input case is returned unshrunk if the
    budget can't even confirm reproduction)."""
    probes = 0

    def probe(c: FuzzCase) -> bool:
        nonlocal probes
        probes += 1
        return _probe(c, d, device)

    # the divergence was observed after burst d.step: later bursts are
    # irrelevant by construction
    cur = _with(case, bursts=_atomize(case.bursts[: d.step + 1]))
    if not probe(cur):
        # atomization changed write-batch ordering semantics for this
        # stream (intra-batch delete-after-touch collapses); fall back
        # to the unatomized prefix
        cur = _with(case, bursts=case.bursts[: d.step + 1])
        if not probe(cur):
            return case  # not reproducible in probe mode; keep as-is

    changed = True
    while changed and probes < probe_budget:
        changed = False
        # drop whole bursts, newest first (older bursts are likelier to
        # be load-bearing seed state)
        i = len(cur.bursts) - 1
        while i >= 0 and probes < probe_budget:
            cand = _with(cur, bursts=cur.bursts[:i] + cur.bursts[i + 1:])
            if probe(cand):
                cur = cand
                changed = True
            i -= 1
        # thin bulk bursts one relationship at a time
        for bi, b in enumerate(cur.bursts):
            if b["kind"] != "bulk":
                continue
            ri = len(b["rels"]) - 1
            while ri >= 0 and probes < probe_budget:
                rels = b["rels"][:ri] + b["rels"][ri + 1:]
                nb = dict(b, rels=rels)
                cand = _with(cur, bursts=(cur.bursts[:bi] + [nb]
                                          + cur.bursts[bi + 1:]))
                if probe(cand):
                    cur = cand
                    b = nb
                    changed = True
                ri -= 1
        # thin the init set one relationship at a time
        ri = len(cur.init_rels) - 1
        while ri >= 0 and probes < probe_budget:
            cand = _with(cur, init_rels=(cur.init_rels[:ri]
                                         + cur.init_rels[ri + 1:]))
            if probe(cand):
                cur = cand
                changed = True
            ri -= 1
    return cur


# -- artifacts ----------------------------------------------------------------


def write_artifact(path: str, case: FuzzCase, d: Divergence) -> str:
    """Self-contained repro artifact; returns the path written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "version": ARTIFACT_VERSION,
        "seed": case.seed,
        "gates": d.gates,
        "role": d.role,
        "kernel": case.kernel,
        "schema": case.schema_text,
        "init_rels": case.init_rels,
        "deltas": case.bursts,
        "delta_count": delta_count(case),
        "query": d.query,
        "jax_answer": d.got,
        "oracle_answer": d.want,
        "revision": d.revision,
        "targets": case.targets,
        "subjects": case.subjects,
        "repro": ("python -m spicedb_kubeapi_proxy_tpu_torch.fuzz "
                  "--replay " + os.path.abspath(path)),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_artifact(path: str):
    """-> (FuzzCase, Divergence) reconstructed from an artifact file."""
    with open(path) as f:
        a = json.load(f)
    case = FuzzCase(seed=a["seed"], schema_text=a["schema"],
                    init_rels=a["init_rels"], bursts=a["deltas"],
                    targets=[tuple(t) for t in a["targets"]],
                    subjects=a["subjects"], kernel=a["kernel"])
    d = Divergence(seed=a["seed"], gates=a["gates"], role=a["role"],
                   kernel=a["kernel"], step=len(a["deltas"]) - 1,
                   query=a["query"], got=a["jax_answer"],
                   want=a["oracle_answer"], revision=a["revision"])
    return case, d


def replay_artifact(path: str, device=None) -> list:
    """Re-run an artifact's cell on `device`; returns the divergences
    seen NOW (empty = the underlying bug is fixed)."""
    case, d = load_artifact(path)
    return run_case(case, gates=d.gates, role=d.role,
                    check_only=d.query, final_only=True, device=device)
