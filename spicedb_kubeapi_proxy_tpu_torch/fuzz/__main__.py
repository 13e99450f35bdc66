"""Differential fuzz of the torch port: the fixed-seed gate x role matrix.

    python -m spicedb_kubeapi_proxy_tpu_torch.fuzz [--device cpu]
        [--seeds 31] [--budget-seconds N [--scenario X]]
        [--replay ART.json] [--mutation MUT]
        [--artifact-dir DIR]

Check mode (the default) replays 31 FIXED seeds at `checkpoints="final"`
— 25 mapped onto the 3 gate combos x 3 replication roles (every cell
covered >= 2x; kernels alternate ell/segment), 2 `sharded2` cells
(a router over two partition leaders), 2 `mesh` cells (a 2x2 mesh
co-located on the device against a single-device endpoint), 2 `leopard`
cells (an indexed endpoint against an index-free one, nested-groups
bias) — and asserts ZERO divergences from the host oracle.  Schemas,
delta streams, clocks and queries all derive from the seed; wall time is
the only thing that varies.  A divergence shrinks to a self-contained
repro artifact and fails the run (exit 1) with its path and seed line.

Other modes:

  --budget-seconds N   open-ended random search (full-depth profile,
                       every checkpoint compared, cells walking every
                       role and both kernels) from seed 1000 until the
                       budget expires; exits 1 on the first
                       divergence with a shrunk artifact.  --scenario X
                       steers it with a scenarios.py bias profile.
  --replay ART.json    re-run an artifact's exact cell (one written by
                       either package); exit 1 while it still diverges,
                       0 once fixed.
  --mutation MUT       self-check: inject a deliberate compiler bug
                       (mutations.py) and verify the fixed seed set
                       CATCHES it and shrinks it (exit 0 = caught).

Everything runs on the CUDA card unless `--device cpu` is given, in this
one process (one CUDA context); without a card the run fails rather
than fall back.  Artifacts go to --artifact-dir (default
$FUZZ_ARTIFACT_DIR, else `authz_fuzz` under the temporary directory).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from .driver import (
    ALL_ROLES,
    GATE_COMBOS,
    LEOPARD_ROLE,
    MESH_ROLE,
    SHARDED_ROLE,
    SMOKE_KERNELS,
    build_case,
    run_case,
    smoke_cell_for,
)
from .mutations import MUTATIONS
from .scenarios import NESTED_GROUPS_SMOKE_BIAS, SCENARIO_BIASES
from .shrink import delta_count, replay_artifact, shrink_case, write_artifact

FIXED_SEEDS = 31
BUDGET_START = 1000       # the budgeted search's first seed


def smoke_case(seed: int):
    """The fixed set's case for `seed`: the smoke profile in the seed's
    cell, the leopard cells under the nested-groups bias (so
    membership-only fragments actually materialize)."""
    gates, role, kernel = smoke_cell_for(seed)
    kw = {}
    if role == LEOPARD_ROLE:
        kw["schema_bias"] = NESTED_GROUPS_SMOKE_BIAS
    return build_case(seed, smoke=True, kernel=kernel, **kw)


def run_cell(seed: int, device=None) -> dict:
    """Replay one fixed cell; returns its seed, cell, wall seconds and
    divergence lines."""
    gates, role, kernel = smoke_cell_for(seed)
    t0 = time.perf_counter()
    divs = run_case(smoke_case(seed), gates=gates, role=role,
                    checkpoints="final", device=device)
    return {"seed": seed, "gates": gates, "role": role, "kernel": kernel,
            "elapsed": time.perf_counter() - t0,
            "divergences": [d.line() for d in divs]}


def coverage_hole(cells_hit: dict, n_seeds: int) -> str:
    """'' when `cells_hit` ({(gates, role): n}) covers what `n_seeds`
    fixed seeds must: the classic 3x3 matrix evenly, then the sharded2,
    mesh and leopard cells alternating off/full.  The expectation is
    derived from the documented walk, independent of `smoke_cell_for`,
    so a regression in the seed-to-cell map itself trips here."""
    n_classic = min(n_seeds, 25)
    want_extra = {}
    for role, first, n in ((SHARDED_ROLE, 25, 2), (MESH_ROLE, 27, 2),
                           (LEOPARD_ROLE, 29, None)):
        k = max(0, n_seeds - first)
        k = k if n is None else min(k, n)
        for gates, v in (("off", (k + 1) // 2), ("full", k // 2)):
            if v:
                want_extra[(gates, role)] = v
    classic = {c: v for c, v in cells_hit.items()
               if c[1] not in (SHARDED_ROLE, MESH_ROLE, LEOPARD_ROLE)}
    extra = {c: v for c, v in cells_hit.items() if c not in classic}
    if (len(classic) != min(9, n_classic)
            or sum(classic.values()) != n_classic
            or any(v < max(1, n_classic // 9) for v in classic.values())
            or extra != want_extra):
        return (f"matrix coverage hole at --seeds {n_seeds}: classic "
                f"{classic}, others {extra} (want {min(9, n_classic)} "
                f"classic cells x >= {max(1, n_classic // 9)}, others "
                f"{want_extra})")
    return ""


def shrink_and_write(case, d, artifact_dir: str, name: str,
                     device=None) -> tuple:
    """Shrink `case` for divergence `d` and write the artifact; returns
    (path, delta count)."""
    small = shrink_case(case, d, device=device)
    path = os.path.join(artifact_dir, name)
    write_artifact(path, small, d)
    return path, delta_count(small)


def run_fixed_set(n_seeds: int, device, artifact_dir: str) -> int:
    t0 = time.perf_counter()
    cells_hit: dict = {}
    failed = []
    for seed in range(n_seeds):
        res = run_cell(seed, device)
        cell = (res["gates"], res["role"])
        cells_hit[cell] = cells_hit.get(cell, 0) + 1
        status = "DIVERGED" if res["divergences"] else "ok"
        print(f"seed {seed:3d} [{res['gates']:5s}/{res['role']:9s}/"
              f"{res['kernel']:7s}] {status} in {res['elapsed']:.2f}s",
              flush=True)
        if res["divergences"]:
            failed.append(res)
    elapsed = time.perf_counter() - t0
    hole = coverage_hole(cells_hit, n_seeds)
    if hole:
        print(f"fuzz: {hole}")
        return 1
    if failed:
        for res in failed:
            for line in res["divergences"]:
                print(line)
            seed = res["seed"]
            gates, role, _ = smoke_cell_for(seed)
            case = smoke_case(seed)
            divs = run_case(case, gates=gates, role=role,
                            checkpoints="final", stop_on_first=True,
                            device=device)
            if not divs:
                print(f"seed {seed}: divergence did not reproduce")
                continue
            path, n = shrink_and_write(
                case, divs[0], artifact_dir,
                f"fuzz-seed{seed}-{gates}-{role}.json", device)
            print(f"seed {seed}: shrunk to {n} deltas -> {path}")
        print(f"fuzz: {len(failed)}/{n_seeds} seeds DIVERGED in "
              f"{elapsed:.1f}s")
        return 1
    print(f"fuzz: {n_seeds} fixed cells agree in {elapsed:.1f}s "
          f"(cells {dict(sorted(cells_hit.items()))})")
    return 0


def budget_cell(seed: int) -> tuple:
    """The (gates, role, kernel) a budgeted-search seed replays: gates
    by seed % 3, every role in turn, kernels alternating every 9 seeds
    (ell for the mesh role, which requires it)."""
    gates = tuple(GATE_COMBOS)[seed % 3]
    role = ALL_ROLES[(seed // 3) % len(ALL_ROLES)]
    kernel = SMOKE_KERNELS[(seed // 9) % 2]
    if role == MESH_ROLE:
        kernel = "ell"
    return gates, role, kernel


def run_budgeted(budget_s: float, device, artifact_dir: str,
                 scenario: str = "") -> int:
    """Open-ended search: full-depth cases, every checkpoint compared,
    until the budget expires."""
    bias_kw = {}
    if scenario:
        sb, db = SCENARIO_BIASES[scenario]
        bias_kw = {"schema_bias": sb, "delta_bias": db}
    t0 = time.perf_counter()
    seed = BUDGET_START
    n = 0
    roles: dict = {}
    while time.perf_counter() - t0 < budget_s:
        gates, role, kernel = budget_cell(seed)
        case = build_case(seed, kernel=kernel, **bias_kw)
        divs = run_case(case, gates=gates, role=role, checkpoints="every",
                        stop_on_first=True, device=device)
        n += 1
        roles[role] = roles.get(role, 0) + 1
        print(f"seed {seed} [{gates}/{role}/{kernel}] "
              f"{'DIVERGED' if divs else 'ok'} "
              f"({time.perf_counter() - t0:.0f}s/{budget_s:.0f}s)",
              flush=True)
        if divs:
            d = divs[0]
            print(d.line())
            path, k = shrink_and_write(
                case, d, artifact_dir, f"fuzz-seed{seed}-{gates}-{role}.json",
                device)
            print(f"seed {seed}: shrunk to {k} deltas -> {path}")
            return 1
        seed += 1
    print(f"budgeted fuzz{' ' + scenario if scenario else ''}: {n} cells "
          f"(seeds {BUDGET_START}-{seed - 1}, roles {roles}) agree in "
          f"{time.perf_counter() - t0:.0f}s")
    return 0


def run_replay(path: str, device) -> int:
    divs = replay_artifact(path, device=device)
    if divs:
        for d in divs:
            print(d.line())
        print(f"replay {path}: still diverges")
        return 1
    print(f"replay {path}: agrees (fixed)")
    return 0


def first_catch(name: str, n_seeds: int, device=None, log=None):
    """Walk the fixed seeds (the smoke profile in each seed's cell, as
    the reference's mutation check walks them) under mutation `name`;
    returns (case, divergence) at the first catch, else (None, None)."""
    with MUTATIONS[name]():
        for seed in range(n_seeds):
            gates, role, kernel = smoke_cell_for(seed)
            case = build_case(seed, smoke=True, kernel=kernel)
            divs = run_case(case, gates=gates, role=role,
                            checkpoints="final", stop_on_first=True,
                            device=device)
            if log is not None:
                log(f"seed {seed} [{gates}/{role}/{kernel}] "
                    f"{'CAUGHT' if divs else 'ok'}")
            if divs:
                return case, divs[0]
    return None, None


def mutation_check(name: str, n_seeds: int, device,
                   artifact_dir: str, log=print) -> dict:
    """Catch mutation `name` with the fixed seeds and shrink it; returns
    {"seed", "line", "path", "deltas"} ({} when not caught)."""
    case, d = first_catch(name, n_seeds, device, log)
    if d is None:
        return {}
    log(d.line())
    with MUTATIONS[name]():
        path, n = shrink_and_write(case, d, artifact_dir,
                                   f"mutation-{name}.json", device)
    return {"seed": case.seed, "line": d.line(), "path": path, "deltas": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spicedb_kubeapi_proxy_tpu_torch.fuzz",
        description="Differential fuzz of torch:// against the host "
                    "oracle across the gate x role matrix.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' twins)")
    ap.add_argument("--seeds", type=int, default=FIXED_SEEDS,
                    help="seeds 0..24 walk the 3x3 gate x role matrix; "
                         "25..26 are sharded2, 27..28 mesh, 29+ leopard")
    ap.add_argument("--budget-seconds", type=float, default=0.0)
    ap.add_argument("--scenario", default="",
                    choices=("",) + tuple(sorted(SCENARIO_BIASES)),
                    help="steer the budgeted search with a scenario "
                         "bias profile")
    ap.add_argument("--replay", default="")
    ap.add_argument("--mutation", default="", choices=("",) + tuple(
        sorted(MUTATIONS)), help="inject a named mutation and require "
                                 "the fixed set to catch it")
    ap.add_argument("--artifact-dir", default=os.environ.get(
        "FUZZ_ARTIFACT_DIR") or os.path.join(tempfile.gettempdir(),
                                             "authz_fuzz"))
    args = ap.parse_args(argv)
    device = args.device
    if args.replay:
        return run_replay(args.replay, device)
    if args.mutation:
        res = mutation_check(args.mutation, args.seeds, device,
                             args.artifact_dir)
        if not res:
            print(f"mutation {args.mutation!r}: NOT caught by the fixed "
                  f"seed set")
            return 1
        print(f"mutation {args.mutation!r}: caught at seed {res['seed']}, "
              f"shrunk to {res['deltas']} deltas -> {res['path']}")
        return 0
    if args.budget_seconds > 0:
        return run_budgeted(args.budget_seconds, device, args.artifact_dir,
                            scenario=args.scenario)
    return run_fixed_set(args.seeds, device, args.artifact_dir)


if __name__ == "__main__":
    sys.exit(main())
