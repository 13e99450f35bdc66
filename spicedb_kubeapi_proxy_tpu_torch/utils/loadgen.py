"""Open-loop workload generator (the reference's utils/loadgen.py,
copied: the same spec gives a byte-identical schedule).

A closed-loop generator waits for each request before sending the next,
so whenever the system stalls it stops offering load and the stall's
victims are never measured — the coordinated-omission bug that flatters
p99 exactly when p99 matters.  This generator is **open-loop**:
`WorkloadSpec.schedule()` lays out a fixed request schedule up front
(Poisson arrivals at the offered rate), and `OpenLoopRunner` fires each
request at its intended time whether or not earlier ones came back,
recording every latency against the INTENDED send time.  A stall now
shows up twice, as it should: queued requests measure the stall they
sat through, and the generator's own inability to keep to the schedule
is exported as `authz_loadgen_lag_seconds` so an overdriven generator
cannot silently flatter the tail either.

The mix models the reference proxy's three rule types over a
million-user id space with zipfian per-user fan-in (a few hot service
accounts dominate, the long tail is cold):

- ``filter`` — filtered LIST (prefilter/LookupResources rule path);
- ``check``  — single-object read (Check rule path);
- ``update`` — dual-write create (Update rule path, write fan-out);
- ``watch``  — watch-churn touches feeding open watch streams;
- ``grant``/``revoke`` — PAuth-style short-TTL ephemeral grants
  (arXiv:2603.17170): each grant event schedules its own revoke at
  t+TTL, so the fleet serves permission churn, not a frozen ACL set.

The schedule is a pure function of the spec (`random.Random(seed)`, no
wall clock): same seed → byte-identical `schedule_lines()`.
"""

from __future__ import annotations

import asyncio
import bisect
import json
import time
from array import array
from dataclasses import dataclass
from typing import Callable

from .metrics import REGISTRY

# scheduler lag: how far behind the intended schedule the generator
# fired its most recent request.  A sustained non-zero value means the
# offered rate exceeds what this generator process can issue — the
# measured latencies are then a lower bound, not a measurement.
LAG_GAUGE = REGISTRY.gauge(
    "authz_loadgen_lag_seconds",
    "Open-loop load generator scheduler lag (actual fire time minus "
    "intended send time) of the most recently fired request")


@dataclass(frozen=True)
class WorkloadSpec:
    """Deterministic open-loop workload description.

    `verb_mix` are relative weights (normalized internally) over the
    filter/check/update rule paths; watch churn and grant bursts ride
    on top at their own rates so the read:write mix stays interpretable.
    """
    seed: int = 20
    duration_s: float = 10.0
    rate_per_s: float = 50.0
    users: int = 1_000_000
    zipf_s: float = 1.2
    verb_mix: tuple = (("filter", 0.6), ("check", 0.25), ("update", 0.15))
    watch_churn_per_s: float = 0.0
    grant_burst_per_s: float = 0.0   # burst arrivals per second
    grant_burst_n: int = 4           # grants per burst
    grant_ttl_s: float = 2.0         # each grant's revoke lands t+TTL
    namespaces: int = 4

    def schedule(self) -> list:
        """The full fixed schedule: a list of event dicts sorted by
        intended send offset `t` (seconds from window start).  Pure
        function of the spec — no wall clock, no global state."""
        import random

        rng = random.Random(self.seed)
        zipf = _ZipfSampler(self.users, self.zipf_s)
        verbs = [v for v, _ in self.verb_mix]
        weights = [w for _, w in self.verb_mix]
        events = []
        seq = 0

        def emit(t, verb, **kw):
            nonlocal seq
            ev = {"t": round(t, 6), "verb": verb,
                  "user": f"u{zipf.sample(rng)}",
                  "ns": f"ns{rng.randrange(self.namespaces)}",
                  "seq": seq}
            ev.update(kw)
            events.append(ev)
            seq += 1

        # main verb stream: Poisson arrivals at the offered rate
        t = 0.0
        while True:
            t += rng.expovariate(self.rate_per_s)
            if t >= self.duration_s:
                break
            verb = rng.choices(verbs, weights)[0]
            if verb == "update":
                emit(t, "update", name=f"obj-{seq}")
            else:
                emit(t, verb)
        # watch churn: touches that feed open watch streams
        if self.watch_churn_per_s > 0:
            t = 0.0
            while True:
                t += rng.expovariate(self.watch_churn_per_s)
                if t >= self.duration_s:
                    break
                emit(t, "watch", name=f"watch-{seq}")
        # short-TTL grant bursts: every grant schedules its own revoke
        if self.grant_burst_per_s > 0:
            t = 0.0
            while True:
                t += rng.expovariate(self.grant_burst_per_s)
                if t >= self.duration_s:
                    break
                for _ in range(self.grant_burst_n):
                    name = f"grant-{seq}"
                    emit(t, "grant", name=name, ttl_s=self.grant_ttl_s)
                    emit(t + self.grant_ttl_s, "revoke", name=name)
        events.sort(key=lambda e: (e["t"], e["seq"]))
        return events

    def schedule_lines(self) -> bytes:
        """Canonical byte encoding of the schedule (sorted keys, no
        whitespace): the determinism contract `same seed → byte-
        identical` is asserted against exactly these bytes."""
        return b"\n".join(
            json.dumps(e, sort_keys=True,
                       separators=(",", ":")).encode()
            for e in self.schedule())


class _ZipfSampler:
    """Bounded zipf(s) over ranks 1..n via inverse-CDF + bisect.

    The CDF is built once per (n, s) — O(n) floats in a C array — so a
    million-user id space costs ~8 MB and sub-second setup, and every
    sample after that is one rng draw + one binary search.  Rank r has
    probability proportional to r^-s, so rank 1 is sampled ~2^s times
    more often than rank 2 — the shape tests pin."""

    _cache: dict = {}

    def __init__(self, n: int, s: float):
        key = (n, round(s, 6))
        cdf = self._cache.get(key)
        if cdf is None:
            cdf = array("d")
            total = 0.0
            for r in range(1, n + 1):
                total += r ** -s
                cdf.append(total)
            self._cache[key] = cdf
        self.cdf = cdf
        self.total = cdf[-1]

    def sample(self, rng) -> int:
        """Rank in 1..n (1 = hottest user)."""
        return bisect.bisect_left(self.cdf, rng.random() * self.total) + 1


def percentile(values, q: float) -> float:
    """Nearest-rank percentile over a sequence (0 on empty)."""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
    return vs[idx]


class OpenLoopRunner:
    """Drive a fixed schedule through an async `issue(event)` callable,
    coordinated-omission-free.

    Each event fires at `window_start + event.t` regardless of whether
    earlier requests completed (their tasks run concurrently and are
    all awaited before `run()` returns), and its latency is recorded as
    `completion − intended_send` — a request that sat in a stall's
    queue is charged the full queue wait.  Scheduler lag (actual fire −
    intended fire) is tracked per event and exported through
    `authz_loadgen_lag_seconds`."""

    def __init__(self, issue: Callable, *,
                 max_inflight: int = 256,
                 clock: Callable[[], float] = time.monotonic):
        self.issue = issue
        self.clock = clock
        self.max_inflight = max_inflight
        self.samples: dict = {}     # verb -> [latency_s]
        self.errors: dict = {}      # verb -> count
        self.max_lag_s = 0.0
        self.offered = 0
        self.achieved = 0
        self.window_s = 0.0

    async def _one(self, ev: dict, intended: float) -> None:
        verb = ev["verb"]
        try:
            await self.issue(ev)
        except Exception:
            self.errors[verb] = self.errors.get(verb, 0) + 1
            return
        self.achieved += 1
        self.samples.setdefault(verb, []).append(
            self.clock() - intended)

    async def run(self, schedule: list) -> dict:
        t0 = self.clock()
        tasks = []
        for ev in schedule:
            intended = t0 + ev["t"]
            delay = intended - self.clock()
            if delay > 0:
                await asyncio.sleep(delay)
            lag = max(0.0, self.clock() - intended)
            if lag > self.max_lag_s:
                self.max_lag_s = lag
            LAG_GAUGE.set(lag)
            self.offered += 1
            # open loop: do NOT await the request here — but keep the
            # in-flight population bounded so an unresponsive system
            # degrades into measured queueing, not task exhaustion
            while len(tasks) >= self.max_inflight:
                done, pending = await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED)
                tasks = list(pending)
            tasks.append(asyncio.create_task(self._one(ev, intended)))
        if tasks:
            await asyncio.gather(*tasks)
        self.window_s = self.clock() - t0
        return self.report()

    def report(self) -> dict:
        per_verb = {}
        for verb, lats in sorted(self.samples.items()):
            per_verb[verb] = {
                "count": len(lats),
                "p50_ms": round(percentile(lats, 0.50) * 1e3, 3),
                "p99_ms": round(percentile(lats, 0.99) * 1e3, 3),
                "errors": self.errors.get(verb, 0),
            }
        all_lats = [x for ls in self.samples.values() for x in ls]
        return {
            "open_loop": True,
            # makespan: schedule start -> last completion.  Under
            # saturation the schedule drains late, so achieved /
            # window_s is the honest capacity measure (never clipped
            # by the generator politely slowing down)
            "window_s": round(self.window_s, 3),
            "offered": self.offered,
            "achieved": self.achieved,
            "errors": sum(self.errors.values()),
            "offered_rate_per_s": round(
                self.offered / self.window_s, 2) if self.window_s else 0.0,
            "p50_ms": round(percentile(all_lats, 0.50) * 1e3, 3),
            "p99_ms": round(percentile(all_lats, 0.99) * 1e3, 3),
            "max_sched_lag_ms": round(self.max_lag_s * 1e3, 3),
            "per_verb": per_verb,
        }
