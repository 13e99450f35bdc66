"""Tail explainer: where does p99 − p50 live?  (The reference's
utils/tailexplain.py, copied: the same merged view gives the same
report.)

The fleet trace plane (utils/fleet.py) already attributes every sampled
cross-process request to tiers and serving stages; this module turns
that population into the question operators actually ask: *which stage
of which tier is the tail?*  `explain()` splits the assembled traces
into a body population (duration ≤ p50) and a tail population
(duration ≥ p99), computes each (tier, stage) component's mean cost in
both populations, and ranks the components by how much MORE they cost
in the tail — a ranked "where the tail lives" report in which the
per-component deltas sum (means are additive; percentiles are not) to
the measured body→tail gap.

Components per request, from the assembled trace:

- each serving stage per tier (`serving_stages_ms`: authn, rule_match,
  kube_upstream, decode, filter, serialize — timeline._SERVING_STAGES);
- per-tier ``other`` — tier self time not covered by serving spans
  (queueing, framing, event-loop wait);
- the ``network`` pseudo-tier — hop time not attributed to any child
  segment.

Served at `/debug/tail` on every proxy and on the shard router
(merged across the fleet).  Pure functions over the merged /debug/fleet
payload: no state, no metrics; the TAIL_EXPLAIN switch
(utils/features.py, the reference's TailExplain gate) turns the report
off without touching trace collection.
"""

from __future__ import annotations


def enabled() -> bool:
    """The TAIL_EXPLAIN switch, read at each use."""
    from . import features
    return features.TAIL_EXPLAIN is True


def _components(trace: dict) -> dict:
    """(tier, stage) -> ms for one assembled trace; covers the whole
    attributed duration (stage spans + per-tier residual + network)."""
    out: dict = {}
    stages = trace.get("serving_stages_ms") or {}
    for tier, ti in (trace.get("tiers") or {}).items():
        self_ms = float(ti.get("self_ms") or 0.0)
        staged = 0.0
        for stage, ms in (stages.get(tier) or {}).items():
            ms = float(ms or 0.0)
            out[(str(tier), str(stage))] = ms
            staged += ms
        # serving spans can nest inside each other and inside hop
        # handling, so the residual is clamped, not assumed exact
        out[(str(tier), "other")] = max(0.0, self_ms - staged)
    net = float(trace.get("network_ms") or 0.0)
    if net > 0:
        out[("network", "hop")] = net
    return out


def _mean_components(traces: list) -> dict:
    sums: dict = {}
    for t in traces:
        for key, ms in _components(t).items():
            sums[key] = sums.get(key, 0.0) + ms
    n = max(1, len(traces))
    return {k: v / n for k, v in sums.items()}


def explain(merged: dict, top: int = 12) -> dict:
    """The /debug/tail payload, from a merged /debug/fleet view.

    Needs at least 2 assembled traces to have a body and a tail to
    diff; below that the report says so instead of inventing one."""
    if not enabled():
        return {"enabled": False,
                "reason": "TailExplain feature gate is off"}
    traces = [t for t in (merged.get("traces") or [])
              if float(t.get("duration_ms") or 0.0) > 0.0]
    if len(traces) < 2:
        return {"enabled": True, "requests": len(traces), "ranked": [],
                "reason": f"need >= 2 assembled multi-process traces, "
                          f"have {len(traces)}"}
    durations = sorted(float(t["duration_ms"]) for t in traces)
    p50 = _pct(durations, 0.50)
    p99 = _pct(durations, 0.99)
    body = [t for t in traces if float(t["duration_ms"]) <= p50]
    tail = [t for t in traces if float(t["duration_ms"]) >= p99]
    if not body:
        body = [min(traces, key=lambda t: float(t["duration_ms"]))]
    if not tail:
        tail = [max(traces, key=lambda t: float(t["duration_ms"]))]
    body_mean = sum(float(t["duration_ms"]) for t in body) / len(body)
    tail_mean = sum(float(t["duration_ms"]) for t in tail) / len(tail)
    gap_ms = max(0.0, tail_mean - body_mean)

    bc = _mean_components(body)
    tc = _mean_components(tail)
    ranked = []
    for key in sorted(set(bc) | set(tc)):
        tier, stage = key
        b = bc.get(key, 0.0)
        t = tc.get(key, 0.0)
        delta = t - b
        ranked.append({
            "tier": tier, "stage": stage,
            "body_mean_ms": round(b, 3),
            "tail_mean_ms": round(t, 3),
            "delta_ms": round(delta, 3),
            "share_of_gap": round(delta / gap_ms, 4) if gap_ms else 0.0,
        })
    ranked.sort(key=lambda r: -r["delta_ms"])
    explained = sum(r["delta_ms"] for r in ranked if r["delta_ms"] > 0)
    stages_seen = sorted({
        stage for t in traces
        for st in (t.get("serving_stages_ms") or {}).values()
        for stage in st})
    return {
        "enabled": True,
        "requests": len(traces),
        "p50_ms": round(p50, 3),
        "p99_ms": round(p99, 3),
        "body_count": len(body),
        "tail_count": len(tail),
        "body_mean_ms": round(body_mean, 3),
        "tail_mean_ms": round(tail_mean, 3),
        "gap_ms": round(gap_ms, 3),
        "stages": stages_seen,
        "ranked": ranked[:top],
        # positive deltas over the gap: ~1.0 means the stage/tier
        # attribution accounts for the whole tail; « 1.0 means the tail
        # lives somewhere the trace plane does not instrument
        "explained_fraction": round(explained / gap_ms, 4)
        if gap_ms else 0.0,
    }


def _pct(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]
