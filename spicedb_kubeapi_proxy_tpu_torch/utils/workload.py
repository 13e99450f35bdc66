"""Workload cost attribution and measured sweep telemetry (the
reference's utils/workload.py, for the torch port).

Device telemetry (utils/devtel.py) says what the card is doing; this
module says for whom — which (resource type, permission) pairs spend
device time, how many sweeps their queries take to converge, how much of
their traffic the decision cache absorbs, and how much goes to the host
oracle.  It is fed from three places:

1. **Measured sweep telemetry** (`note_sweep`): the port's fixpoint
   (ops/ell.py `_evaluate`, ops/spmv.py) already returns its trace —
   trace[0] the executed sweeps, trace[1:1+trace[0]] the bits each sweep
   changed — because the host loop reads each sweep's change count to
   decide whether to sweep again; no readback is added for it.  Exported
   as `authz_sweep_iterations{kernel,verb}` and
   `authz_frontier_decay{kernel,verb}` (the ratio of successive sweeps'
   changed bits).

2. **Device-time attribution** (`note_device_time`): the devtel
   kernel-span hook forwards the same seconds that feed
   `authz_kernel_time_seconds{phase=kernel.device|kernel.dispatch}` —
   on the card, the CUDA-event window of a batch — with the batch's
   (type, permission, rows) composition, so the per-pair rows reconcile
   with the histogram by construction.

3. **Routing and cache hooks** (`note_batch` / `note_depth` /
   `note_oracle` / `note_cache`): batch occupancy and measured depth per
   pair, oracle-routed rows, and decision-cache hits and misses.

The rolled-up view is served at the authed `/debug/workload`;
`leopard_candidates()` names the pairs whose measured depth and
recursive footprint make them Leopard-index candidates, and the endpoint
builds each generation's index with them first (`candidate_order=`).

The `KERNEL_INTROSPECT` switch (utils/features.py, the reference's
`KernelIntrospect` gate) is the killswitch: off, nothing here records.
Thread-safe; recording happens from executor threads concurrently.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

from . import metrics as m

# measured mean sweep depth at or above this flags a pair as a
# Leopard-index candidate (staged Gauss-Seidel converges flat schemas in
# 2 sweeps — propagate + confirm — so sustained depth >= 3 means real
# nested propagation is happening)
LEOPARD_DEPTH = float(os.environ.get("SPICEDB_TPU_LEOPARD_DEPTH", "3"))

_ITER_BUCKETS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32)
_DECAY_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                  1.0, 2.0)

# kernel-span phases that represent the device window — the phases whose
# authz_kernel_time_seconds observations the per-pair rows reconcile with
DEVICE_PHASES = frozenset(("kernel.device", "kernel.dispatch"))


def enabled() -> bool:
    """The KERNEL_INTROSPECT switch, read at each use."""
    from . import features
    return features.KERNEL_INTROSPECT is True


@dataclass
class SweepRecord:
    """One batch's measured sweep telemetry, decoded from the int32
    trace the fixpoint returns: tel[0] = executed sweeps,
    tel[1:1+iterations] = the bits each sweep changed."""
    kernel: str
    verb: str
    iterations: int
    deltas: tuple


class WorkloadAccounting:
    """Rolling per-(resource type, permission) cost attribution."""

    def __init__(self, registry: Optional[m.Registry] = None):
        registry = registry or m.REGISTRY
        self._lock = threading.Lock()
        self._rows: dict = {}          # (type, perm) -> mutable row dict
        self._total_device_s = 0.0     # all DEVICE_PHASES seconds seen
        self._attributed_s = 0.0       # seconds split onto pairs
        self._schema = None            # most recent endpoint schema
        self._footprints: dict = {}    # (type, perm) -> frozenset
        self._leopard_status: dict = {}  # "type#perm" -> index status
        self._tls = threading.local()  # per-thread last SweepRecord
        self._sweep_iters = registry.histogram(
            "authz_sweep_iterations",
            "Measured fixpoint sweeps per kernel batch (the trace the "
            "host sweep loop reads)",
            labels=("kernel", "verb"), buckets=_ITER_BUCKETS)
        self._decay = registry.histogram(
            "authz_frontier_decay",
            "Frontier-population ratio between successive sweep "
            "iterations (near 0 = fast convergence, near 1 = deep "
            "nested propagation)",
            labels=("kernel", "verb"), buckets=_DECAY_BUCKETS)

    # -- measured sweep telemetry -------------------------------------------

    def note_sweep(self, kernel: str, verb: str,
                   tel) -> Optional[SweepRecord]:
        """Record one sweep's readback telemetry; returns the decoded
        record (also stashed thread-locally for `take_last_sweep`) or
        None when gated off / the trace is malformed."""
        if not enabled() or tel is None:
            return None
        try:
            iters = int(tel[0])
            if iters < 0:
                return None
            deltas = tuple(int(x) for x in tel[1:1 + iters])
        except (TypeError, ValueError, IndexError):
            return None
        rec = SweepRecord(kernel=kernel, verb=verb, iterations=iters,
                          deltas=deltas)
        self._sweep_iters.observe(iters, kernel=kernel, verb=verb)
        for prev, cur in zip(deltas, deltas[1:]):
            if prev > 0:
                self._decay.observe(min(cur / prev, 2.0),
                                    kernel=kernel, verb=verb)
        self._tls.last = rec
        return rec

    def take_last_sweep(self) -> Optional[SweepRecord]:
        """Pop the calling thread's most recent SweepRecord."""
        rec = getattr(self._tls, "last", None)
        self._tls.last = None
        return rec

    # -- per-pair attribution -----------------------------------------------

    def _row_locked(self, pair: tuple) -> dict:
        row = self._rows.get(pair)
        if row is None:
            row = {"device_s": 0.0, "device_calls": 0, "kernel_rows": 0,
                   "oracle_rows": 0, "sweep_iter_rows": 0.0,
                   "sweep_rows": 0, "occ_sum": 0.0, "occ_batches": 0,
                   "cache_hits": 0, "cache_misses": 0}
            self._rows[pair] = row
        return row

    def note_device_time(self, comp: Optional[Iterable], phase: str,
                         seconds: float) -> None:
        """One device-window span's seconds, with the batch composition
        `comp` = iterable of (resource_type, permission, rows).  The
        seconds are split across pairs by row share; spans with no
        composition still count toward the reconciliation total."""
        if not enabled() or phase not in DEVICE_PHASES or seconds < 0:
            return
        comp = list(comp or ())
        total_rows = sum(max(0, int(r)) for _, _, r in comp)
        with self._lock:
            self._total_device_s += seconds
            if total_rows <= 0:
                return
            self._attributed_s += seconds
            for rtype, perm, rows in comp:
                rows = max(0, int(rows))
                if not rows:
                    continue
                row = self._row_locked((str(rtype), str(perm)))
                row["device_s"] += seconds * rows / total_rows
                row["device_calls"] += 1

    def note_batch(self, comp: Optional[Iterable], verb: str,
                   iterations: Optional[int] = None,
                   occupancy: Optional[float] = None) -> None:
        """Per-batch routing stats: kernel-served rows, batch occupancy,
        and measured depth when given.  The endpoint calls this at
        capture without iterations and feeds the depth through
        `note_depth` when the batch's readback completes."""
        if not enabled():
            return
        with self._lock:
            for rtype, perm, rows in comp or ():
                rows = max(0, int(rows))
                if not rows:
                    continue
                row = self._row_locked((str(rtype), str(perm)))
                row["kernel_rows"] += rows
                if iterations is not None:
                    row["sweep_iter_rows"] += iterations * rows
                    row["sweep_rows"] += rows
                if occupancy is not None:
                    row["occ_sum"] += occupancy
                    row["occ_batches"] += 1

    def note_depth(self, comp: Optional[Iterable],
                   iterations: int) -> None:
        """Row-weighted measured sweep depth only (at readback: the
        batch's rows and occupancy were counted at capture)."""
        if not enabled():
            return
        with self._lock:
            for rtype, perm, rows in comp or ():
                rows = max(0, int(rows))
                if not rows:
                    continue
                row = self._row_locked((str(rtype), str(perm)))
                row["sweep_iter_rows"] += iterations * rows
                row["sweep_rows"] += rows

    def note_oracle(self, comp: Optional[Iterable]) -> None:
        """Rows answered by the host oracle instead of the kernel."""
        if not enabled():
            return
        with self._lock:
            for rtype, perm, rows in comp or ():
                rows = max(0, int(rows))
                if rows:
                    self._row_locked(
                        (str(rtype), str(perm)))["oracle_rows"] += rows

    def note_cache(self, rtype: str, perm: str, hits: int,
                   misses: int) -> None:
        """Decision-cache probe outcome for one pair."""
        if not enabled():
            return
        with self._lock:
            row = self._row_locked((str(rtype), str(perm)))
            row["cache_hits"] += int(hits)
            row["cache_misses"] += int(misses)

    def note_schema(self, schema) -> None:
        """Remember the serving schema for the nesting detector (the
        most recent endpoint construction wins)."""
        with self._lock:
            self._schema = schema
            self._footprints.clear()

    def note_leopard_status(self, statuses: Optional[dict]) -> None:
        """Per-pair Leopard index status ("type#perm" ->
        `indexed | indexed(quarantined) | ineligible(reason)`), fed by
        the endpoint at every index install (ops/leopard.py
        `status_map`); surfaces in the /debug/workload rows."""
        with self._lock:
            self._leopard_status = dict(statuses or {})

    # -- Leopard-candidate detection ----------------------------------------

    def _footprint_locked(self, pair: tuple) -> frozenset:
        fp = self._footprints.get(pair)
        if fp is None:
            fp = frozenset()
            if self._schema is not None:
                try:
                    from ..ops.graph_compile import relation_footprint
                    fp = relation_footprint(self._schema, pair[0], pair[1])
                except Exception:
                    fp = frozenset()
            self._footprints[pair] = fp
        return fp

    def _nested_locked(self, pair: tuple) -> bool:
        """True when the pair's relation footprint contains a userset
        cycle — a relation reachable from itself through >= 1 declared
        userset reference (`member: user | group#member`, or a mutual
        a -> b -> a chain).  Flat schemas have only terminal subject
        types, so this never fires for them."""
        schema = self._schema
        if schema is None:
            return False
        edges: dict = {}

        def succ(node: tuple) -> list:
            out = edges.get(node)
            if out is None:
                d = schema.definitions.get(node[0])
                refs = d.relations.get(node[1], ()) if d is not None else ()
                out = [(ref.type, ref.relation) for ref in refs
                       if getattr(ref, "relation", None)]
                edges[node] = out
            return out

        for start in self._footprint_locked(pair):
            stack = list(succ(start))
            seen: set = set()
            while stack:
                node = stack.pop()
                if node == start:
                    return True
                if node in seen:
                    continue
                seen.add(node)
                stack.extend(succ(node))
        return False

    def leopard_candidates(self) -> list:
        """Pairs whose measured mean sweep depth is at or above
        LEOPARD_DEPTH and whose footprint is structurally recursive —
        the permissions a Leopard-style materialized group index would
        pay off for."""
        with self._lock:
            pairs = [(pair, row) for pair, row in self._rows.items()
                     if row["sweep_rows"] > 0]
            out = []
            for pair, row in pairs:
                depth = row["sweep_iter_rows"] / row["sweep_rows"]
                if depth >= LEOPARD_DEPTH and self._nested_locked(pair):
                    out.append({"resource_type": pair[0],
                                "permission": pair[1],
                                "mean_sweep_depth": round(depth, 2),
                                "kernel_rows": row["kernel_rows"]})
            out.sort(key=lambda c: -c["mean_sweep_depth"])
            return out

    # -- rolled-up view ------------------------------------------------------

    def payload(self) -> dict:
        """The /debug/workload body: per-pair rows (device-time-sorted),
        totals, and the attribution/σ(kernel histogram) reconciliation."""
        candidates = self.leopard_candidates()
        cand_pairs = {(c["resource_type"], c["permission"])
                      for c in candidates}
        with self._lock:
            rows = []
            for (rtype, perm), r in self._rows.items():
                routed = r["kernel_rows"] + r["oracle_rows"]
                probes = r["cache_hits"] + r["cache_misses"]
                # actionable Leopard status: installed-index verdicts win
                # (indexed / ineligible(reason)); with no verdict — gate
                # off, or no install yet — a detector-flagged pair shows
                # `candidate` so operators see what an index would buy
                leopard = self._leopard_status.get(f"{rtype}#{perm}")
                if leopard is None:
                    leopard = ("candidate" if (rtype, perm) in cand_pairs
                               else "ineligible(unplanned)")
                rows.append({
                    "leopard": leopard,
                    "resource_type": rtype,
                    "permission": perm,
                    "device_s": round(r["device_s"], 6),
                    "device_calls": r["device_calls"],
                    "kernel_rows": r["kernel_rows"],
                    "oracle_rows": r["oracle_rows"],
                    "oracle_fraction": (round(r["oracle_rows"] / routed, 4)
                                        if routed else None),
                    "mean_sweep_depth": (
                        round(r["sweep_iter_rows"] / r["sweep_rows"], 2)
                        if r["sweep_rows"] else None),
                    "mean_occupancy": (round(r["occ_sum"] / r["occ_batches"],
                                             4) if r["occ_batches"] else None),
                    "cache_hits": r["cache_hits"],
                    "cache_misses": r["cache_misses"],
                    "cache_hit_rate": (round(r["cache_hits"] / probes, 4)
                                       if probes else None),
                })
            total = self._total_device_s
            attributed = self._attributed_s
        rows.sort(key=lambda r: -r["device_s"])
        return {
            "rows": rows,
            "attributed_device_s": round(attributed, 6),
            "total_device_s": round(total, 6),
            "attribution_ratio": (round(attributed / total, 4)
                                  if total > 0 else None),
            "leopard_depth_threshold": LEOPARD_DEPTH,
            "leopard_candidates": candidates,
        }

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()
            self._total_device_s = 0.0
            self._attributed_s = 0.0
            self._leopard_status.clear()


WORKLOAD = WorkloadAccounting()


def note_sweep(kernel: str, verb: str, tel) -> Optional[SweepRecord]:
    return WORKLOAD.note_sweep(kernel, verb, tel)


def take_last_sweep() -> Optional[SweepRecord]:
    return WORKLOAD.take_last_sweep()


def note_device_time(comp, phase: str, seconds: float) -> None:
    WORKLOAD.note_device_time(comp, phase, seconds)


def comp_rows(reqs: Sequence) -> list:
    """Collapse a CheckRequest sequence into the (type, permission, rows)
    composition stamped on kernel spans."""
    agg: dict = {}
    for r in reqs:
        pair = (r.resource.type, r.permission)
        agg[pair] = agg.get(pair, 0) + 1
    return [(t, p, n) for (t, p), n in agg.items()]
