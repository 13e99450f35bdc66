"""Seeded differential fuzzing harness of the torch port.

The port's counterpart of the reference's fuzz/ package, with the same
module and public names.  Three parts, one contract: a seed integer
fully determines a (schema, delta-stream, query-stream) triple (equal to
the reference's for the same seed and biases), the triple replays
identically against the `torch://` device endpoints and the host oracle
at pinned revisions, and any answer mismatch anywhere in the gate matrix
(DecisionCache x DevicePipeline x AsyncRebuild) or the replication role
matrix (leader / 2-hop follower chain / promoted leader, plus the
sharded, mesh and Leopard cells) surfaces as a one-line reproducible
seed that shrinks to a self-contained artifact.

- `schema_gen`   random schemas (bounded-depth rewrites, arrows,
  intersections/exclusions, wildcards, CEL caveats, expiring
  relations), biased toward deep/entangled closures via
  `relation_footprint`
- `delta_gen`    random delta streams (writes, deletes,
  delete_by_filter, bulk loads, TTL churn against a FAKE clock,
  wildcard flips, plane-less caveats that force quarantine/rebuild)
- `driver`       the differential replay across gates x roles
- `shrink`       delta-stream minimizer + repro artifacts
- `mutations`    deliberate compiler bugs the fixed set must catch
- `scenarios`    the four scenario workloads (caveat-heavy /
  wildcard-public / ephemeral-grants / group-explosion) + fuzz biases
- `metrics`      `authz_fuzz_*` counters (the FUZZ_TELEMETRY switch)

`python -m spicedb_kubeapi_proxy_tpu_torch.fuzz` runs the fixed-seed
matrix, a budgeted campaign, a replay or a mutation check (__main__.py).
"""

from .driver import (  # noqa: F401
    GATE_COMBOS,
    ROLES,
    Divergence,
    FuzzCase,
    build_case,
    run_case,
    run_seed,
    smoke_cell_for,
)
from .mutations import MUTATIONS  # noqa: F401
from .scenarios import SCENARIO_BIASES, SCENARIO_WORKLOADS  # noqa: F401
from .schema_gen import generate_schema  # noqa: F401
from .shrink import (  # noqa: F401
    load_artifact,
    replay_artifact,
    shrink_case,
    write_artifact,
)
