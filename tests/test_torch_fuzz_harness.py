"""The port's own fuzz harness (`spicedb_kubeapi_proxy_tpu_torch/fuzz/`)
held against the reference's (`spicedb_kubeapi_proxy_tpu/fuzz/`).

- Generators: for the same seed and bias, the port's `build_case`
  serializes equal to the reference's (schema text byte for byte, the
  initial load, the burst stream, the targets and subjects): seeds 0-30
  of the smoke profile and 0-9 of the full one, under the default bias
  and each scenario bias; the bias profiles themselves are equal, and
  the four scenario workloads give equal schemas and tuples at small
  sizes.
- The seed-to-cell map and the gate combos are the reference's.
- Replay: a sample of the fixed cells (seeds 3, 4, 8 for the three
  replication roles, 25 `sharded2`, 27 `mesh`, 29 `leopard`) gives zero
  divergences on `device="cpu"` (the kernels' plain-torch twins);
  answers are exact, so there is no tolerance.  The switches a combo
  sets are restored after a run, failed runs included.
- The tripwire: under each mutation, `first_catch` stops on the same
  seed in both packages, and the port's shrunk artifact diverges under
  the mutation and replays clean without it.
- Artifacts cross-load in both directions and replay in the other
  package.
- `authz_fuzz_*`: nothing is recorded with FUZZ_TELEMETRY off; on, the
  cases, divergences and shrink probes are counted.
- The command line (`python -m spicedb_kubeapi_proxy_tpu_torch.fuzz`)
  in check, mutation and replay mode on the CPU.
"""

import json

import pytest

from spicedb_kubeapi_proxy_tpu.fuzz import driver as ref_driver
from spicedb_kubeapi_proxy_tpu.fuzz import scenarios as ref_scenarios
from spicedb_kubeapi_proxy_tpu.fuzz import schema_gen as ref_schema_gen
from spicedb_kubeapi_proxy_tpu.fuzz import shrink as ref_shrink
from spicedb_kubeapi_proxy_tpu.fuzz.delta_gen import (
    DEFAULT_DELTA_BIAS as REF_DELTA_BIAS, EPOCH as REF_EPOCH)
from spicedb_kubeapi_proxy_tpu.fuzz.mutations import (
    MUTATIONS as REF_MUTATIONS)
from spicedb_kubeapi_proxy_tpu.utils.features import GATES as REF_GATES
from spicedb_kubeapi_proxy_tpu_torch import fuzz
from spicedb_kubeapi_proxy_tpu_torch.device import DeviceUnavailableError
from spicedb_kubeapi_proxy_tpu_torch.fuzz import __main__ as cli
from spicedb_kubeapi_proxy_tpu_torch.fuzz import driver, scenarios, shrink
from spicedb_kubeapi_proxy_tpu_torch.fuzz import metrics as fuzz_metrics
from spicedb_kubeapi_proxy_tpu_torch.fuzz import schema_gen
from spicedb_kubeapi_proxy_tpu_torch.fuzz.delta_gen import (
    DEFAULT_DELTA_BIAS, EPOCH, FakeClock)
from spicedb_kubeapi_proxy_tpu_torch.fuzz.mutations import MUTATIONS
from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as sch
from spicedb_kubeapi_proxy_tpu_torch.spicedb.schema_lint import lint_schema
from spicedb_kubeapi_proxy_tpu_torch.utils import features

BIASES = ["default"] + sorted(scenarios.SCENARIO_BIASES)
SAMPLED_CELLS = (3, 4, 8, 25, 27, 29)
SWITCHES = ("DECISION_CACHE", "DEVICE_PIPELINE", "ASYNC_REBUILD")


@pytest.fixture(autouse=True)
def restore_reference_gates():
    yield
    REF_GATES.reset()


def _biases(name: str, port: bool) -> tuple:
    if name == "default":
        return ((schema_gen.DEFAULT_BIAS, DEFAULT_DELTA_BIAS) if port
                else (ref_schema_gen.DEFAULT_BIAS, REF_DELTA_BIAS))
    return (scenarios if port else ref_scenarios).SCENARIO_BIASES[name]


def case_json(case) -> str:
    return json.dumps({"seed": case.seed, "schema": case.schema_text,
                       "init": case.init_rels, "bursts": case.bursts,
                       "targets": [list(t) for t in case.targets],
                       "subjects": case.subjects, "kernel": case.kernel},
                      sort_keys=True)


def _cases(bias: str, seed: int, smoke: bool, kernel: str = "ell") -> tuple:
    sb, db = _biases(bias, True)
    rsb, rdb = _biases(bias, False)
    return (fuzz.build_case(seed, schema_bias=sb, delta_bias=db,
                            smoke=smoke, kernel=kernel),
            ref_driver.build_case(seed, schema_bias=rsb, delta_bias=rdb,
                                  smoke=smoke, kernel=kernel))


# -- generators ---------------------------------------------------------------


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("seed", range(31))
def test_smoke_profile_case_equals_the_reference(bias, seed):
    port, ref = _cases(bias, seed, smoke=True)
    assert case_json(port) == case_json(ref)


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("seed", range(10))
def test_full_profile_case_equals_the_reference(bias, seed):
    port, ref = _cases(bias, seed, smoke=False, kernel="segment")
    assert case_json(port) == case_json(ref)


def test_leopard_cells_case_equals_the_reference():
    """The fixed set's leopard cells build under the nested-groups smoke
    bias; the CLI's `smoke_case` is the reference script's case."""
    for seed in range(25, 35):
        g, r, k = driver.smoke_cell_for(seed)
        kw = ({"schema_bias": ref_scenarios.NESTED_GROUPS_SMOKE_BIAS}
              if r == "leopard" else {})
        ref = ref_driver.build_case(seed, smoke=True, kernel=k, **kw)
        assert case_json(cli.smoke_case(seed)) == case_json(ref)


def test_bias_profiles_equal_the_reference():
    pairs = [(schema_gen.DEFAULT_BIAS, ref_schema_gen.DEFAULT_BIAS),
             (schema_gen.SMOKE_BIAS, ref_schema_gen.SMOKE_BIAS),
             (DEFAULT_DELTA_BIAS, REF_DELTA_BIAS),
             (scenarios.NESTED_GROUPS_SMOKE_BIAS,
              ref_scenarios.NESTED_GROUPS_SMOKE_BIAS)]
    assert (sorted(scenarios.SCENARIO_BIASES)
            == sorted(ref_scenarios.SCENARIO_BIASES))
    for name, (sb, db) in scenarios.SCENARIO_BIASES.items():
        rsb, rdb = ref_scenarios.SCENARIO_BIASES[name]
        pairs += [(sb, rsb), (db, rdb)]
    for port, ref in pairs:
        assert vars(port) == vars(ref)
    assert EPOCH == REF_EPOCH


_WORKLOAD_KWARGS = {
    "caveat-heavy": {"n_docs": 300, "n_users": 40, "n_groups": 8},
    "wildcard-public": {"n_docs": 300, "n_users": 40, "n_groups": 8},
    "ephemeral-grants": {"n_docs": 300, "n_users": 30, "n_tasks": 6,
                         "now": EPOCH},
    "group-explosion": {"n_groups": 400, "n_users": 50, "n_docs": 120,
                        "depth": 8},
}


@pytest.mark.parametrize("name", sorted(_WORKLOAD_KWARGS))
def test_scenario_workload_equals_the_reference(name):
    assert (sorted(scenarios.SCENARIO_WORKLOADS)
            == sorted(ref_scenarios.SCENARIO_WORKLOADS))
    kw = _WORKLOAD_KWARGS[name]
    port = scenarios.SCENARIO_WORKLOADS[name](**kw)
    ref = ref_scenarios.SCENARIO_WORKLOADS[name](**kw)
    assert vars(port) == vars(ref)
    assert len(port.relationships) > 100


def test_generated_schemas_parse_and_lint_clean_in_the_port():
    """The port's lint finds no error in a generated schema."""
    for seed in range(20):
        for bias in (schema_gen.DEFAULT_BIAS, schema_gen.SMOKE_BIAS):
            text, schema = fuzz.generate_schema(seed, bias=bias)
            assert (sch.parse_schema(text).definitions.keys()
                    == schema.definitions.keys())
            errors = [f for f in lint_schema(schema)
                      if f.severity == "error"]
            assert not errors, (seed, text, errors)


def test_fake_clock_only_moves_on_advance():
    c = FakeClock()
    t0 = c.now()
    assert c.now() == t0 == EPOCH
    c.advance(5.0)
    assert c.now() == t0 + 5.0


def test_cell_map_and_gate_combos_equal_the_reference():
    assert driver.GATE_COMBOS == ref_driver.GATE_COMBOS
    assert driver.ROLES == ref_driver.ROLES
    assert driver.ALL_ROLES == ref_driver.ALL_ROLES
    for seed in range(45):
        assert driver.smoke_cell_for(seed) == ref_driver.smoke_cell_for(seed)
    for gate in driver.GATE_COMBOS["full"]:
        assert gate in features.GATE_SWITCHES


@pytest.mark.parametrize("n_seeds", [9, 25, 27, 29, 31, 33])
def test_coverage_check_accepts_the_walk_and_finds_a_hole(n_seeds):
    cells: dict = {}
    for seed in range(n_seeds):
        g, r, _ = driver.smoke_cell_for(seed)
        cells[(g, r)] = cells.get((g, r), 0) + 1
    assert cli.coverage_hole(cells, n_seeds) == ""
    dropped = dict(cells)
    dropped.pop(next(iter(dropped)))
    assert cli.coverage_hole(dropped, n_seeds) != ""


# -- the replay ---------------------------------------------------------------


@pytest.mark.parametrize("seed", SAMPLED_CELLS)
def test_sampled_fixed_cell_agrees_with_the_oracle(seed):
    res = cli.run_cell(seed, device="cpu")
    assert (res["gates"], res["role"], res["kernel"]) == \
        ref_driver.smoke_cell_for(seed)
    assert res["divergences"] == []


def test_run_case_needs_a_card_unless_the_cpu_is_asked_for():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    case = fuzz.build_case(4, smoke=True)
    with pytest.raises(DeviceUnavailableError):
        fuzz.run_case(case, gates="off", role="leader", checkpoints="final")
    with pytest.raises(DeviceUnavailableError):
        fuzz.run_seed(4)


def test_gates_restored_after_a_run():
    before = {n: getattr(features, n) for n in SWITCHES}
    case = fuzz.build_case(4, smoke=True)
    assert fuzz.run_case(case, gates="full", role="leader",
                         checkpoints="final", device="cpu") == []
    assert {n: getattr(features, n) for n in SWITCHES} == before
    case = fuzz.build_case(3, smoke=True)
    assert fuzz.run_case(case, gates="off", role="follower2",
                         checkpoints="ends", device="cpu") == []
    assert {n: getattr(features, n) for n in SWITCHES} == before


def test_gates_restored_when_a_run_raises(monkeypatch):
    before = {n: getattr(features, n) for n in SWITCHES}

    def boom(*a, **k):
        raise RuntimeError("endpoint build failed")

    monkeypatch.setattr(driver._RoleHarness, "build_endpoint", boom)
    with pytest.raises(RuntimeError):
        fuzz.run_case(fuzz.build_case(4, smoke=True), gates="full",
                      device="cpu")
    assert {n: getattr(features, n) for n in SWITCHES} == before
    with driver.gates_set("off"):
        assert not any(getattr(features, n) for n in SWITCHES)
    with driver.gates_set("full"):
        assert all(getattr(features, n) for n in SWITCHES)
    assert {n: getattr(features, n) for n in SWITCHES} == before


def test_full_gates_run_behind_the_dispatcher_and_the_cache():
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.decision_cache import (
        DecisionCacheEndpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.dispatch import (
        BatchingEndpoint)
    case = fuzz.build_case(4, smoke=True)
    chains = {}
    for gates in driver.GATE_COMBOS:
        h = driver._RoleHarness("leader", FakeClock(), 0)
        ep = h.build_endpoint(case.parsed_schema(), "ell", gates, "cpu")
        chain = []
        while ep is not None:
            chain.append(type(ep))
            ep = getattr(ep, "inner", None)
        chains[gates] = chain
    assert chains == {
        "off": [TorchEndpoint],
        "cache": [DecisionCacheEndpoint, TorchEndpoint],
        "full": [DecisionCacheEndpoint, BatchingEndpoint, TorchEndpoint]}


@pytest.mark.slow
def test_full_profile_every_checkpoint():
    """The budgeted-search profile (deep schemas, per-burst checkpoints)
    on a few seeds across the roles."""
    for seed, role in ((1, "leader"), (2, "follower2"), (5, "promoted"),
                       (6, "sharded2"), (7, "mesh"), (8, "leopard")):
        case = fuzz.build_case(seed)
        divs = fuzz.run_case(case, gates="full", role=role,
                             checkpoints="every", device="cpu")
        assert divs == [], [d.line() for d in divs]


# -- the tripwire and the artifacts -------------------------------------------


def _ref_first_catch(mutation: str, max_seeds: int = 45):
    with REF_MUTATIONS[mutation]():
        for seed in range(max_seeds):
            gates, role, kernel = ref_driver.smoke_cell_for(seed)
            case = ref_driver.build_case(seed, smoke=True, kernel=kernel)
            divs = ref_driver.run_case(case, gates=gates, role=role,
                                       checkpoints="final",
                                       stop_on_first=True)
            if divs:
                return case, divs[0]
    return None, None


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_mutation_caught_on_the_reference_seed_and_shrunk(mutation,
                                                          tmp_path):
    assert sorted(MUTATIONS) == sorted(REF_MUTATIONS)
    case, d = cli.first_catch(mutation, 45, device="cpu")
    ref_case, ref_d = _ref_first_catch(mutation)
    assert d is not None and ref_d is not None
    assert case.seed == ref_case.seed
    assert (d.gates, d.role, d.kernel, d.step, d.query, d.got, d.want,
            d.revision) == (ref_d.gates, ref_d.role, ref_d.kernel,
                            ref_d.step, ref_d.query, ref_d.got, ref_d.want,
                            ref_d.revision)
    with MUTATIONS[mutation]():
        small = fuzz.shrink_case(case, d, device="cpu")
        path = fuzz.write_artifact(str(tmp_path / "m.json"), small, d)
        live = fuzz.replay_artifact(path, device="cpu")
    assert live, "the shrunk artifact lost the divergence"
    assert shrink.delta_count(small) <= 10
    assert fuzz.replay_artifact(path, device="cpu") == []
    a = json.loads(open(path).read())
    assert a["delta_count"] == shrink.delta_count(small)
    assert a["version"] == shrink.ARTIFACT_VERSION == \
        ref_shrink.ARTIFACT_VERSION


def test_artifacts_cross_load_both_ways(tmp_path):
    """A port artifact loads in the reference and replays clean on
    `jax://`; a reference artifact loads in the port, replays clean on
    `torch://?device=cpu` and diverges there under the mutation."""
    mutation = "wildcard-plane-skipped"
    case, d = cli.first_catch(mutation, 45, device="cpu")
    port_path = fuzz.write_artifact(str(tmp_path / "port.json"), case, d)
    ref_case, ref_d = _ref_first_catch(mutation)
    ref_path = ref_shrink.write_artifact(str(tmp_path / "ref.json"),
                                         ref_case, ref_d)
    port_json = json.loads(open(port_path).read())
    ref_json = json.loads(open(ref_path).read())
    assert set(port_json) == set(ref_json)
    assert ({k: v for k, v in port_json.items() if k != "repro"}
            == {k: v for k, v in ref_json.items() if k != "repro"})
    lc, ld = ref_shrink.load_artifact(port_path)
    assert case_json(lc) == case_json(case)
    assert (ld.gates, ld.role, ld.query) == (d.gates, d.role, d.query)
    lc, ld = fuzz.load_artifact(ref_path)
    assert case_json(lc) == case_json(ref_case)
    assert (ld.gates, ld.role, ld.query) == (ref_d.gates, ref_d.role,
                                             ref_d.query)
    assert ref_shrink.replay_artifact(port_path) == []
    assert fuzz.replay_artifact(ref_path, device="cpu") == []
    with MUTATIONS[mutation]():
        assert fuzz.replay_artifact(ref_path, device="cpu")


# -- fuzz telemetry -----------------------------------------------------------


def _counts() -> tuple:
    return (fuzz_metrics._cases.value(), fuzz_metrics._divergences.value(),
            fuzz_metrics._shrink_probes.value())


def test_telemetry_switch_off_records_nothing(monkeypatch):
    monkeypatch.setattr(features, "FUZZ_TELEMETRY", False)
    before = _counts()
    fuzz_metrics.note_case(diverged=True)
    fuzz_metrics.note_shrink_probe()
    case = fuzz.build_case(1, smoke=True)
    with MUTATIONS["wildcard-plane-skipped"]():
        divs = fuzz.run_case(case, gates="cache", role="leader",
                             checkpoints="final", stop_on_first=True,
                             device="cpu")
        assert divs
        fuzz.shrink_case(case, divs[0], probe_budget=3, device="cpu")
    assert _counts() == before


def test_telemetry_switch_on_counts_cases_divergences_and_probes(
        monkeypatch):
    monkeypatch.setattr(features, "FUZZ_TELEMETRY", True)
    c0, d0, p0 = _counts()
    assert fuzz.run_case(fuzz.build_case(4, smoke=True), gates="off",
                         checkpoints="final", device="cpu") == []
    assert _counts() == (c0 + 1, d0, p0)
    case = fuzz.build_case(1, smoke=True)
    with MUTATIONS["wildcard-plane-skipped"]():
        divs = fuzz.run_case(case, gates="cache", role="leader",
                             checkpoints="final", stop_on_first=True,
                             device="cpu")
        assert divs
        assert _counts() == (c0 + 2, d0 + 1, p0)
        fuzz.shrink_case(case, divs[0], probe_budget=3, device="cpu")
    c, d, p = _counts()
    # probes count as probes, never as cases
    assert (c, d) == (c0 + 2, d0 + 1) and p >= p0 + 3
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import REGISTRY
    text = REGISTRY.render()
    for name in ("authz_fuzz_cases_total", "authz_fuzz_divergences_total",
                 "authz_fuzz_shrink_probes_total"):
        assert name in text


# -- the command line ---------------------------------------------------------


def test_cli_check_mode_on_the_cpu(capsys):
    assert cli.main(["--device", "cpu", "--seeds", "9"]) == 0
    out = capsys.readouterr().out
    assert "fuzz: 9 fixed cells agree" in out
    assert out.count(" ok in ") == 9


def test_cli_mutation_and_replay_modes_on_the_cpu(tmp_path, capsys):
    art = str(tmp_path / "arts")
    assert cli.main(["--device", "cpu", "--mutation",
                     "wildcard-plane-skipped", "--artifact-dir", art]) == 0
    out = capsys.readouterr().out
    assert "caught at seed 1" in out
    path = f"{art}/mutation-wildcard-plane-skipped.json"
    assert cli.main(["--device", "cpu", "--replay", path]) == 0
    assert "agrees (fixed)" in capsys.readouterr().out
    with MUTATIONS["wildcard-plane-skipped"]():
        assert cli.main(["--device", "cpu", "--replay", path]) == 1
    assert "still diverges" in capsys.readouterr().out


def test_cli_budgeted_mode_on_the_cpu(capsys):
    assert cli.main(["--device", "cpu", "--budget-seconds", "0.01",
                     "--scenario", "nested-groups"]) == 0
    out = capsys.readouterr().out
    assert "budgeted fuzz nested-groups: 1 cells" in out


def test_cli_fixed_set_failure_writes_an_artifact(tmp_path, capsys,
                                                  monkeypatch):
    """A divergence in check mode fails the run with its seed line and
    the shrunk artifact's path."""
    art = tmp_path / "arts"
    with MUTATIONS["wildcard-plane-skipped"]():
        assert cli.main(["--device", "cpu", "--seeds", "2",
                         "--artifact-dir", str(art)]) == 1
    out = capsys.readouterr().out
    assert "DIVERGENCE seed=1 gates=cache role=leader" in out
    assert f"-> {art}/fuzz-seed1-cache-leader.json" in out
    assert (art / "fuzz-seed1-cache-leader.json").exists()
