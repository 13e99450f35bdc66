"""`authz_fuzz_*` counters of the port's fuzz harness.

The harness is an offline tool, but its runs ride the same metrics
registry the server exports (utils/metrics.py `REGISTRY`), so a long
`--budget-seconds` campaign can be scraped or snapshotted like any other
workload.  The FUZZ_TELEMETRY switch (utils/features.py, the reference's
`FuzzTelemetry` gate) is the killswitch, read at every call: off, every
recording helper is inert."""

from __future__ import annotations

from ..utils import features
from ..utils import metrics as m

_cases = m.REGISTRY.counter(
    "authz_fuzz_cases_total",
    "Differential fuzz (case, gate-combo, role) cells replayed")
_divergences = m.REGISTRY.counter(
    "authz_fuzz_divergences_total",
    "Fuzz replays that produced >=1 torch-vs-oracle divergence")
_shrink_probes = m.REGISTRY.counter(
    "authz_fuzz_shrink_probes_total",
    "Replay probes spent minimizing failing delta streams")


def fuzz_telemetry_enabled() -> bool:
    return features.FUZZ_TELEMETRY is True


def note_case(diverged: bool) -> None:
    if not fuzz_telemetry_enabled():
        return
    _cases.inc()
    if diverged:
        _divergences.inc()


def note_shrink_probe() -> None:
    if fuzz_telemetry_enabled():
        _shrink_probes.inc()
