"""Fleet aggregation plane: cross-process trace assembly and roll-ups
(the reference's utils/fleet.py, copied: the same member dicts give the
same merged payload).

The proxy fleet is a stateless router in front of N shard leaders with
fan-out follower trees; every per-process observability surface
(/debug/traces, /debug/flight, /metrics) stops at its own process
boundary.  This module is the merge half of fleet tracing:

- `collect_fleet()` fans a /debug/fleet request out to each member's
  /debug/traces + /debug/flight + /metrics and normalizes the answers
  into member dicts (errors are per-member, never fatal — a dead
  follower still leaves the rest of the fleet explorable).
- `merge_fleet()` is PURE (no HTTP, unit-testable): it assembles the
  per-process traces into cross-process traces keyed by trace id,
  aligns each child trace inside its parent's hop span (by the
  PARENT's clock — never the remote wall clock, so cross-process clock
  skew cannot reorder the merged timeline), renders one
  Perfetto-loadable chrome-trace with one track per (tier, process),
  attributes per-tier self time + per-hop network time so the tier sums
  reconcile against the root (client-observed) latency by construction,
  and rolls up per-tier p50/p99 and the members' SLO burn lists.

Alignment model: every outbound internal hop records a client-side span
carrying a `span_id` attr (tracing.hop_span); the downstream trace
carries that id as its `parent_span` attr.  A child's offset on the
merged timeline is therefore `offset(parent) + hop_span.start_ms` —
two processes' wall clocks are never subtracted from each other.  The
residual `hop_ms - child_duration_ms` is the hop's network share,
attributed to the pseudo-tier `network`.
"""

from __future__ import annotations

import asyncio
import re
from typing import Iterable, Optional

# /metrics lines worth lifting into the merged view (full scrape text is
# deliberately NOT echoed back — the merge is a roll-up, not a mirror)
_SKEW_RE = re.compile(
    r"^authz_clock_skew_seconds(?:\{[^}]*\})?\s+(-?[0-9.eE+-]+)\s*$",
    re.MULTILINE)
_LAG_RE = re.compile(
    r"^authz_replica_lag_seconds(?:\{[^}]*\})?\s+(-?[0-9.eE+-]+)\s*$",
    re.MULTILINE)

# paths the fan-out scrapes per member
MEMBER_PATHS = ("/debug/traces", "/debug/flight", "/debug/workload",
                "/metrics")


def parse_metric(text: str, pattern: re.Pattern) -> Optional[float]:
    m = pattern.search(text or "")
    if m is None:
        return None
    try:
        return float(m.group(1))
    except ValueError:
        return None


async def fetch_member(url: str, headers: Iterable = (),
                       transport=None, timeout_s: float = 5.0) -> dict:
    """Scrape one fleet member's observability surfaces into a member
    dict; any failure lands in `error` (one member down must not take
    the merged view down)."""
    from ..proxy.httpcore import H11Transport, Headers, Request
    from . import tracing
    member = {"url": url, "error": None, "traces": [], "flight": {},
              "workload": {}, "skew_s": None, "lag_s": None}
    t = transport if transport is not None else H11Transport(url)
    for path in MEMBER_PATHS:
        h = Headers(list(headers))
        h.set("Accept", "application/json")
        # the fan-out is itself a fleet-internal hop: it carries the
        # propagation headers (tier path provenance; empty gate-off)
        for hk, hv in tracing.propagation_headers().items():
            h.set(hk, hv)
        try:
            resp = await asyncio.wait_for(
                t.round_trip(Request(method="GET", target=path,
                                     headers=h)),
                timeout_s)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            member["error"] = f"GET {path}: {e}"
            break
        if resp.status != 200:
            member["error"] = f"GET {path}: HTTP {resp.status}"
            break
        body = resp.body or b""
        if path == "/metrics":
            text = body.decode("utf-8", "replace")
            member["skew_s"] = parse_metric(text, _SKEW_RE)
            member["lag_s"] = parse_metric(text, _LAG_RE)
            continue
        import json
        try:
            payload = json.loads(body or b"{}")
        except ValueError as e:
            member["error"] = f"GET {path}: bad JSON: {e}"
            break
        if path == "/debug/traces":
            member["traces"] = list(payload.get("traces") or [])
        elif path == "/debug/workload":
            member["workload"] = payload
        else:
            member["flight"] = payload
    return member


async def collect_fleet(urls: Iterable[str], headers: Iterable = (),
                        transports: Optional[dict] = None,
                        timeout_s: float = 5.0) -> list:
    """Fan out to every member concurrently; order follows `urls`.
    `transports` (url -> Transport) is the test seam, mirroring
    Options.peer_transports."""
    transports = transports or {}
    return list(await asyncio.gather(*(
        fetch_member(u, headers=headers, transport=transports.get(u),
                     timeout_s=timeout_s)
        for u in urls)))


# -- pure merge ---------------------------------------------------------------


def _percentile(values: list, q: float) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
    return vs[idx]


def _segments_by_trace(members: list) -> dict:
    """trace_id -> list of (member, trace_dict) segments.

    Deduped by segment fingerprint: when a node aggregates itself AND
    appears in its own peer list (or several in-process members share
    one trace recorder, as the tests do), the same segment arrives
    twice; keying on (start, duration, tier, span count) keeps one copy
    without ever collapsing two genuinely distinct segments."""
    out: dict = {}
    seen: set = set()
    for member in members:
        for trd in member.get("traces") or []:
            tid = trd.get("trace_id")
            if not tid:
                continue
            attrs = trd.get("attrs") or {}
            fp = (tid,
                  round(float(trd.get("start_unix") or 0.0), 4),
                  round(float(trd.get("duration_ms") or 0.0), 4),
                  str(attrs.get("tier") or ""),
                  len(trd.get("spans") or []))
            if fp in seen:
                continue
            seen.add(fp)
            out.setdefault(tid, []).append((member, trd))
    return out


def _hop_spans(trace: dict) -> list:
    """The client-side hop spans (tracing.hop_span) of one segment."""
    return [s for s in trace.get("spans") or []
            if (s.get("attrs") or {}).get("span_id")]


def assemble_trace(segments: list) -> dict:
    """Merge one trace id's per-process segments into a single aligned
    timeline.  `segments` is [(member, trace_dict), ...]."""
    # root: the segment that did not join anyone else's trace.  Fall
    # back to earliest wall start (skew-prone, flagged) when the root
    # segment was evicted from its recorder.
    root_ix = None
    for i, (_m, trd) in enumerate(segments):
        if not (trd.get("attrs") or {}).get("parent_span"):
            root_ix = i
            break
    aligned_by_wall = root_ix is None
    if root_ix is None:
        root_ix = min(range(len(segments)),
                      key=lambda i: segments[i][1].get("start_unix", 0.0))
    # span_id -> (segment index, hop span) across all segments
    hop_index: dict = {}
    for i, (_m, trd) in enumerate(segments):
        for sp in _hop_spans(trd):
            hop_index[(sp.get("attrs") or {}).get("span_id")] = (i, sp)
    # child offset = parent offset + hop start (parent's clock).  The
    # parent chain is at most the tier depth; iterate to fixpoint.
    offsets = {root_ix: 0.0}
    wall_fallbacks = 0
    root_trd = segments[root_ix][1]
    for _round in range(len(segments) + 1):
        progressed = False
        for i, (_m, trd) in enumerate(segments):
            if i in offsets:
                continue
            parent = (trd.get("attrs") or {}).get("parent_span")
            hit = hop_index.get(parent)
            if hit is not None and hit[0] in offsets:
                offsets[i] = offsets[hit[0]] + hit[1].get("start_ms", 0.0)
                progressed = True
        if not progressed:
            break
    for i, (_m, trd) in enumerate(segments):
        if i not in offsets:
            # orphan (its parent's segment is missing): wall-clock
            # fallback, counted so readers know the alignment is soft
            offsets[i] = max(0.0, (trd.get("start_unix", 0.0)
                                   - root_trd.get("start_unix", 0.0)) * 1e3)
            wall_fallbacks += 1
    # per-tier attribution: self time = segment duration minus the hop
    # spans that have a matching child segment; the residual
    # hop - child duration is that hop's network share.  Tier sums then
    # reconcile against the root duration by construction — PROVIDED
    # each child segment fits inside its parent's hop span.  Under CPU
    # starvation a child finalizes its segment after flushing the
    # response, so its recorded duration can overrun the hop that
    # carried it; that overrun is finalization delay, not serving work
    # (the parent already had the response), and left unclamped it
    # double-counts and compounds down a deep tier chain.  Cap each
    # non-root segment at its parent hop span; genuinely parallel
    # fan-out (several hops concurrent inside one segment) still sums
    # past the root duration, as it physically should.
    parent_hop_cap: dict = {}
    for i, (_m, trd) in enumerate(segments):
        hit = hop_index.get((trd.get("attrs") or {}).get("parent_span"))
        if hit is not None and hit[0] != i:
            parent_hop_cap[i] = float(hit[1].get("duration_ms") or 0.0)
    tiers: dict = {}
    stages: dict = {}
    network_ms = 0.0
    for i, (_m, trd) in enumerate(segments):
        attrs = trd.get("attrs") or {}
        tier = str(attrs.get("tier") or "unknown")
        dur = float(trd.get("duration_ms") or 0.0)
        if i in parent_hop_cap:
            dur = min(dur, parent_hop_cap[i])
        child_hops_ms = 0.0
        for sp in _hop_spans(trd):
            sid = (sp.get("attrs") or {}).get("span_id")
            child = next((j for j, (_m2, t2) in enumerate(segments)
                          if (t2.get("attrs") or {}).get("parent_span")
                          == sid), None)
            if child is None:
                continue
            hop_ms = float(sp.get("duration_ms") or 0.0)
            child_ms = float(
                segments[child][1].get("duration_ms") or 0.0)
            child_hops_ms += hop_ms
            network_ms += max(0.0, hop_ms - child_ms)
        ti = tiers.setdefault(tier, {"self_ms": 0.0, "segments": 0})
        ti["self_ms"] += max(0.0, dur - child_hops_ms)
        ti["segments"] += 1
        for sp in trd.get("spans") or []:
            name = sp.get("name") or ""
            if name.startswith("serving."):
                st = stages.setdefault(tier, {})
                st[name[len("serving."):]] = round(
                    st.get(name[len("serving."):], 0.0)
                    + float(sp.get("duration_ms") or 0.0), 3)
    root_ms = float(root_trd.get("duration_ms") or 0.0)
    attributed = sum(t["self_ms"] for t in tiers.values()) + network_ms
    return {
        "trace_id": root_trd.get("trace_id"),
        "start_unix": root_trd.get("start_unix"),
        "duration_ms": root_ms,
        "root_attrs": root_trd.get("attrs") or {},
        "tier_count": len(tiers),
        "tiers": {k: {"self_ms": round(v["self_ms"], 3),
                      "segments": v["segments"]}
                  for k, v in sorted(tiers.items())},
        "serving_stages_ms": stages,
        "network_ms": round(network_ms, 3),
        "attributed_ms": round(attributed, 3),
        "aligned_by_wall": aligned_by_wall,
        "wall_fallbacks": wall_fallbacks,
        "segments": [
            {"tier": (trd.get("attrs") or {}).get("tier", "unknown"),
             "url": m.get("url", ""),
             "offset_ms": round(offsets[i], 3),
             "duration_ms": trd.get("duration_ms"),
             "spans": trd.get("spans") or []}
            for i, (m, trd) in enumerate(segments)],
    }


def merged_chrome_trace(assembled: list) -> dict:
    """ONE Perfetto-loadable chrome-trace over every assembled trace:
    one track (pid/tid pair) per (tier, process), slices placed at the
    skew-immune merged offsets (µs since the earliest root's wall
    start)."""
    events = []
    tracks: dict = {}  # (tier, url) -> (pid, tid)
    if not assembled:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"reason": "no multi-process traces"}}
    anchor = min(a.get("start_unix") or 0.0 for a in assembled)

    def track(tier: str, url: str):
        key = (tier, url)
        if key not in tracks:
            pid = len(tracks) + 1
            tracks[key] = (pid, 1)
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 1,
                "args": {"name": f"{tier} @ {url or 'local'}"}})
        return tracks[key]

    for a in assembled:
        base_us = ((a.get("start_unix") or 0.0) - anchor) * 1e6
        for seg in a["segments"]:
            pid, tid = track(str(seg.get("tier") or "unknown"),
                             str(seg.get("url") or ""))
            seg_us = base_us + seg["offset_ms"] * 1e3
            events.append({
                "name": f"request {a['trace_id']}", "ph": "X",
                "pid": pid, "tid": tid, "ts": seg_us,
                "dur": float(seg.get("duration_ms") or 0.0) * 1e3,
                "cat": "request",
                "args": {"trace_id": a["trace_id"]}})
            for sp in seg["spans"]:
                events.append({
                    "name": sp.get("name", "?"), "ph": "X",
                    "pid": pid, "tid": tid,
                    "ts": seg_us + float(sp.get("start_ms") or 0.0) * 1e3,
                    "dur": float(sp.get("duration_ms") or 0.0) * 1e3,
                    "cat": "span",
                    "args": sp.get("attrs") or {}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"anchor_unix": anchor,
                          "traces": len(assembled),
                          "tracks": len(tracks)}}


def merge_workload(members: list) -> dict:
    """Fleet-wide workload roll-up (pure): per-(type, permission) rows
    summed across members, Leopard candidates deduped keeping each
    pair's deepest observation (tagged with the member that saw it)."""
    rows: dict = {}
    candidates: dict = {}
    total = attributed = 0.0
    reporting = 0
    for m in members:
        wl = m.get("workload") or {}
        if not wl or wl.get("enabled") is False or "rows" not in wl:
            continue
        reporting += 1
        total += float(wl.get("total_device_s") or 0.0)
        attributed += float(wl.get("attributed_device_s") or 0.0)
        for r in wl.get("rows") or []:
            key = (str(r.get("resource_type")), str(r.get("permission")))
            agg = rows.setdefault(key, {
                "device_s": 0.0, "kernel_rows": 0, "oracle_rows": 0,
                "cache_hits": 0, "cache_misses": 0})
            agg["device_s"] += float(r.get("device_s") or 0.0)
            for f in ("kernel_rows", "oracle_rows", "cache_hits",
                      "cache_misses"):
                agg[f] += int(r.get(f) or 0)
        for c in wl.get("leopard_candidates") or []:
            key = (str(c.get("resource_type")), str(c.get("permission")))
            cur = candidates.get(key)
            if (cur is None or (c.get("mean_sweep_depth") or 0)
                    > (cur.get("mean_sweep_depth") or 0)):
                candidates[key] = dict(c, url=m.get("url", ""))
    out_rows = []
    for (t, p), agg in rows.items():
        row = {"resource_type": t, "permission": p}
        row.update(agg)
        row["device_s"] = round(agg["device_s"], 6)
        out_rows.append(row)
    out_rows.sort(key=lambda r: -r["device_s"])
    return {
        "members_reporting": reporting,
        "rows": out_rows,
        "total_device_s": round(total, 6),
        "attributed_device_s": round(attributed, 6),
        "leopard_candidates": sorted(
            candidates.values(),
            key=lambda c: -(c.get("mean_sweep_depth") or 0)),
    }


def merge_fleet(members: list) -> dict:
    """The /debug/fleet payload: assembled cross-process traces (multi-
    process trace ids only), ONE merged chrome-trace, per-tier p50/p99
    attribution, fleet workload roll-up, SLO burn roll-up, and
    per-member skew/lag/errors."""
    by_trace = _segments_by_trace(members)
    assembled = [assemble_trace(segs)
                 for _tid, segs in sorted(by_trace.items())
                 if len(segs) > 1]
    assembled.sort(key=lambda a: a.get("duration_ms") or 0.0,
                   reverse=True)
    tier_samples: dict = {}
    for a in assembled:
        for tier, ti in a["tiers"].items():
            tier_samples.setdefault(tier, []).append(ti["self_ms"])
        if a["network_ms"] > 0:
            tier_samples.setdefault("network", []).append(a["network_ms"])
    tier_stats = {
        tier: {"count": len(vals),
               "p50_ms": round(_percentile(vals, 0.50), 3),
               "p99_ms": round(_percentile(vals, 0.99), 3)}
        for tier, vals in sorted(tier_samples.items())}
    burning = []
    for m in members:
        for slo in (m.get("flight") or {}).get("burning") or []:
            burning.append({"url": m.get("url", ""), "slo": slo})
    return {
        "members": [{"url": m.get("url", ""),
                     "error": m.get("error"),
                     "traces": len(m.get("traces") or []),
                     "skew_s": m.get("skew_s"),
                     "lag_s": m.get("lag_s")}
                    for m in members],
        "traces": assembled,
        "chrome_trace": merged_chrome_trace(assembled),
        "tiers": tier_stats,
        "workload": merge_workload(members),
        "slo_burning": burning,
    }
