"""Import rules of the torch port.

The port imports torch, never jax, and nothing of the reference package
`spicedb_kubeapi_proxy_tpu` — whose name is a prefix of the port's own
(`spicedb_kubeapi_proxy_tpu_torch`), so every check here matches the
module name exactly or with a trailing dot, never by bare prefix.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "spicedb_kubeapi_proxy_tpu_torch"
REF = "spicedb_kubeapi_proxy_tpu"


def _is_forbidden(name: str) -> bool:
    return (name in ("jax", REF) or name.startswith("jax.")
            or name.startswith(REF + "."))


_PROBE = r"""
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises
import asyncio
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, EndpointConfigError, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef
ep = create_endpoint("torch://?device=cpu", Bootstrap(
    "definition user {}\ndefinition doc { relation viewer: user\n"
    "permission view = viewer }", "doc:d1#viewer@user:ann"))
ids = asyncio.run(ep.lookup_resources("doc", "view", SubjectRef("user", "ann")))
import torch
try:
    create_endpoint("torch://")
    default = "built on " + str(torch.device("cuda"))
except Exception as e:
    default = type(e).__name__
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"ids": list(ids), "modules": loaded,
                  "cuda": torch.cuda.is_available(), "default": default}))
"""


def test_port_runs_with_jax_blocked_and_imports_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ids"] == ["d1"]
    bad = [m for m in res["modules"] if _is_forbidden(m)]
    assert bad == []
    assert "yaml" not in res["modules"]
    if res["cuda"]:
        assert res["default"].startswith("built on")
    else:
        # no silent CPU fallback: the default device is CUDA
        assert res["default"] == "DeviceUnavailableError"


_PROBE_SLICE4 = r"""
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises
import asyncio
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef
bs = Bootstrap(
    "definition user {}\ndefinition group { relation member: user | "
    "group#member }\ndefinition doc { relation viewer: group#member | user"
    "\npermission view = viewer }",
    "group:g0#member@group:g1#member\ngroup:g1#member@user:ann\n"
    "doc:d1#viewer@group:g0#member")
out = {}
for kernel in ("ell", "segment"):
    ep = create_endpoint("torch://?device=cpu", bs, kernel=kernel)
    ids = asyncio.run(ep.lookup_resources("doc", "view",
                                          SubjectRef("user", "ann")))
    out[kernel] = [list(ids), ep._leopard.status_map()["doc#view"],
                   ep.stats["leopard_lookups"]]
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"out": out, "modules": loaded}))
"""


def test_index_and_segment_kernel_run_with_jax_blocked():
    """The slice-4 modules (ops/leopard.py, ops/spmv.py) load and serve
    with jax unimportable, and import nothing of the reference."""
    out = subprocess.run([sys.executable, "-c", _PROBE_SLICE4], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for kernel in ("ell", "segment"):
        assert res["out"][kernel] == [["d1"], "indexed", 1]
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    assert {"spicedb_kubeapi_proxy_tpu_torch.ops.leopard",
            "spicedb_kubeapi_proxy_tpu_torch.ops.spmv"} <= set(res["modules"])


_PROBE_SLICE5 = r"""
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises
import asyncio
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef
bs = Bootstrap(
    "definition user {}\ndefinition doc { relation viewer: user\n"
    "permission view = viewer }", "doc:d1#viewer@user:ann")
ep = create_endpoint("torch://?mesh=2x4&device=cpu", bs)
ids = asyncio.run(ep.lookup_resources("doc", "view",
                                      SubjectRef("user", "ann")))
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"ids": list(ids), "mesh": ep.mesh.shape,
                  "graph": type(ep._graph).__name__, "modules": loaded}))
"""


def test_mesh_path_runs_with_jax_blocked():
    """The slice-5 modules (parallel/, utils/features.py) load and serve
    `torch://?mesh=` with jax unimportable, and import nothing of the
    reference."""
    out = subprocess.run([sys.executable, "-c", _PROBE_SLICE5], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ids"] == ["d1"] and res["graph"] == "_ShardedEllGraph"
    assert res["mesh"] == {"data": 2, "graph": 4}
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    assert {"spicedb_kubeapi_proxy_tpu_torch.parallel.sharding",
            "spicedb_kubeapi_proxy_tpu_torch.parallel.collectives",
            "spicedb_kubeapi_proxy_tpu_torch.utils.features"} <= \
        set(res["modules"])


_PROBE_DISPATCH = r"""
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises
import asyncio
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef
ep = create_endpoint("torch://?device=cpu", Bootstrap(
    "definition user {}\ndefinition doc { relation viewer: user\n"
    "permission view = viewer }", "doc:d1#viewer@user:ann"))

async def burst():
    return await asyncio.gather(*[ep.lookup_resources(
        "doc", "view", SubjectRef("user", u)) for u in ("ann", "bob")])

ids = [list(x) for x in asyncio.run(burst())]
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"ids": ids, "type": type(ep).__name__,
                  "fused": ep.stats["max_fused_batch"], "modules": loaded}))
"""


def test_batched_dispatch_runs_with_jax_blocked():
    """The dispatcher modules (spicedb/dispatch.py, utils/admission.py,
    utils/failpoints.py) load and serve `torch://`'s default batched
    dispatch with jax unimportable, and import nothing of the reference."""
    out = subprocess.run([sys.executable, "-c", _PROBE_DISPATCH], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ids"] == [["d1"], []] and res["type"] == "BatchingEndpoint"
    assert res["fused"] == 2
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    assert {"spicedb_kubeapi_proxy_tpu_torch.spicedb.dispatch",
            "spicedb_kubeapi_proxy_tpu_torch.utils.admission",
            "spicedb_kubeapi_proxy_tpu_torch.utils.failpoints"} <= \
        set(res["modules"])


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_file_of_the_port_imports_jax_or_the_reference(path):
    bad = [m for m in _imports(ROOT / path) if _is_forbidden(m)]
    assert bad == [], f"{path} imports {bad}"


def test_forbidden_name_check_is_exact():
    assert _is_forbidden("spicedb_kubeapi_proxy_tpu")
    assert _is_forbidden("spicedb_kubeapi_proxy_tpu.ops.ell")
    assert not _is_forbidden("spicedb_kubeapi_proxy_tpu_torch")
    assert not _is_forbidden("spicedb_kubeapi_proxy_tpu_torch.ops.ell")
    assert _is_forbidden("jax.numpy") and not _is_forbidden("jaxtyping")


def test_device_resolution_never_falls_back():
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.device import (
        DeviceUnavailableError, resolve_device)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            resolve_device(None)
        with pytest.raises(DeviceUnavailableError):
            resolve_device("cuda")


_PROBE_PROXY = r"""
import json, sys
for name in ("jax", "h11", "yaml", "cryptography"):
    sys.modules[name] = None       # importing any of them now raises
import asyncio
from spicedb_kubeapi_proxy_tpu_torch.authz import middleware
from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
    FakeKubeApiServer)
from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import HandlerTransport
from spicedb_kubeapi_proxy_tpu_torch.proxy.server import Options, ProxyServer
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
kube = FakeKubeApiServer()
for p in ("p0", "p1"):
    kube.seed("", "v1", "pods", {"metadata": {"name": p, "namespace": "ns"}})
rule = proxyrule.parse_doc({
    "apiVersion": "authzed.com/v1alpha1", "kind": "ProxyRule",
    "metadata": {"name": "pod-enumerate"},
    "match": [{"apiVersion": "v1", "resource": "pods", "verbs": ["list"]}],
    "prefilter": [{"fromObjectIDNamespaceExpr":
                   "{{split_namespace(resourceId)}}",
                   "fromObjectIDNameExpr": "{{split_name(resourceId)}}",
                   "lookupMatchingResources": {
                       "tpl": "pod:$#view@user:{{user.name}}"}}]})
proxy = ProxyServer(Options(
    spicedb_endpoint="torch://?device=cpu", rule_configs=[rule],
    bootstrap=Bootstrap(
        "definition user {}\ndefinition pod { relation viewer: user\n"
        "permission view = viewer }", "pod:ns/p1#viewer@user:ann"),
    upstream_transport=HandlerTransport(kube)))

async def go():
    resp = await proxy.get_embedded_client(user="ann").get("/api/v1/pods")
    return resp.status, [i["metadata"]["name"]
                         for i in json.loads(resp.body)["items"]]

status, names = asyncio.run(go())
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"status": status, "names": names, "modules": loaded,
                  "inner": type(proxy.endpoint.inner).__name__}))
"""


def test_proxy_serves_without_h11_yaml_or_cryptography():
    """The port's proxy (proxy/server.py, authz/middleware.py,
    kubefake/apiserver.py and what they import) loads and serves an
    embedded-client list over `torch://?device=cpu` with jax, h11, yaml
    and cryptography unimportable, and imports nothing of the
    reference."""
    out = subprocess.run([sys.executable, "-c", _PROBE_PROXY], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["status"] == 200 and res["names"] == ["p1"]
    assert res["inner"] == "BatchingEndpoint"
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    assert {"spicedb_kubeapi_proxy_tpu_torch.proxy.server",
            "spicedb_kubeapi_proxy_tpu_torch.authz.middleware",
            "spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver",
            "spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint"} <= \
        set(res["modules"])


# -- the dual-write and command-line modules ---------------------------------

NEW_MODULES = [
    "spicedb_kubeapi_proxy_tpu_torch.authz.distributedtx",
    "spicedb_kubeapi_proxy_tpu_torch.authz.distributedtx.journal",
    "spicedb_kubeapi_proxy_tpu_torch.authz.distributedtx.engine",
    "spicedb_kubeapi_proxy_tpu_torch.authz.distributedtx.workflow",
    "spicedb_kubeapi_proxy_tpu_torch.authz.distributedtx.activity",
    "spicedb_kubeapi_proxy_tpu_torch.authz.distributedtx.client",
    "spicedb_kubeapi_proxy_tpu_torch.authz.update",
    "spicedb_kubeapi_proxy_tpu_torch.proxy.kubeconfig",
    "spicedb_kubeapi_proxy_tpu_torch.cli",
    "spicedb_kubeapi_proxy_tpu_torch.__main__",
    "spicedb_kubeapi_proxy_tpu_torch.entry",
]

_BLOCK = ("import sys\n"
          "for name in ('jax', 'h11', 'yaml', 'cryptography'):\n"
          "    sys.modules[name] = None   # importing any of them raises\n")

_PROBE_NEW = _BLOCK + r"""
import importlib, json
mods = json.loads(sys.argv[1])
for m in mods:
    if m.endswith("__main__"):
        continue   # runs main() only as a script
    importlib.import_module(m)
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps(loaded))
"""


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_imports_nothing_forbidden(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert path.exists(), module
    bad = [m for m in _imports(path) if _is_forbidden(m)]
    assert bad == [], f"{module} imports {bad}"


def test_new_modules_load_with_jax_h11_yaml_and_cryptography_blocked():
    out = subprocess.run([sys.executable, "-c", _PROBE_NEW,
                          json.dumps(NEW_MODULES)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if _is_forbidden(m)]
    main = "spicedb_kubeapi_proxy_tpu_torch.__main__"
    assert set(NEW_MODULES) - {main} <= set(loaded)


def test_module_help_runs_with_jax_h11_yaml_and_cryptography_blocked():
    probe = _BLOCK + (
        "import runpy\n"
        "sys.argv = ['spicedb_kubeapi_proxy_tpu_torch', '--help']\n"
        "runpy.run_module('spicedb_kubeapi_proxy_tpu_torch',"
        " run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--spicedb-endpoint" in out.stdout
    assert "--workflow-database-path" in out.stdout


_PROBE_DUALWRITE = _BLOCK + r"""
import asyncio, json
from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
    FakeKubeApiServer)
from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import HandlerTransport
from spicedb_kubeapi_proxy_tpu_torch.proxy.server import Options, ProxyServer
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
rules = [proxyrule.parse_doc({
    "apiVersion": "authzed.com/v1alpha1", "kind": "ProxyRule",
    "metadata": {"name": "pod-launch"}, "lock": "Optimistic",
    "match": [{"apiVersion": "v1", "resource": "pods", "verbs": ["create"]}],
    "update": {"creates": [
        {"tpl": "pod:{{namespacedName}}#creator@user:{{user.name}}"}]}})]
kube = FakeKubeApiServer()
proxy = ProxyServer(Options(
    spicedb_endpoint="torch://?device=cpu", rule_configs=rules,
    bootstrap=Bootstrap.from_mapping({"schema":
        "definition user {}\ndefinition pod { relation creator: user\n"
        "permission view = creator }"}),
    upstream_transport=HandlerTransport(kube)))
proxy.enable_dual_writes()

async def go():
    resp = await proxy.get_embedded_client(user="ann").post(
        "/api/v1/namespaces/ns/pods",
        {"metadata": {"name": "p0", "namespace": "ns"}})
    return resp.status

status = asyncio.run(go())
rels = sorted(r.rel_string() for r in proxy.endpoint.store.read(None)
              if r.resource.type == "pod")
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"status": status, "rels": rels, "modules": loaded}))
"""


def test_dual_write_serves_with_jax_h11_yaml_and_cryptography_blocked():
    """A rule and a bootstrap given as mappings load without yaml, and a
    dual-write create lands through the port's workflow engine."""
    out = subprocess.run([sys.executable, "-c", _PROBE_DUALWRITE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["status"] == 201
    assert res["rels"] == ["pod:ns/p0#creator@user:ann"]
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    assert ("spicedb_kubeapi_proxy_tpu_torch.authz.distributedtx.engine"
            in res["modules"])


# the decision cache and the device-telemetry modules
TELEMETRY_MODULES = [
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.decision_cache",
    "spicedb_kubeapi_proxy_tpu_torch.utils.devtel",
    "spicedb_kubeapi_proxy_tpu_torch.utils.timeline",
    "spicedb_kubeapi_proxy_tpu_torch.utils.workload",
    "spicedb_kubeapi_proxy_tpu_torch.utils.profiler",
]


@pytest.mark.parametrize("module", TELEMETRY_MODULES)
def test_telemetry_module_imports_nothing_forbidden(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    assert path.exists(), module
    bad = [m for m in _imports(path) if _is_forbidden(m)]
    assert bad == [], f"{module} imports {bad}"


_PROBE_CACHE = _BLOCK + r"""
import asyncio, json
from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
    FakeKubeApiServer)
from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import HandlerTransport
from spicedb_kubeapi_proxy_tpu_torch.proxy.server import Options, ProxyServer
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef
kube = FakeKubeApiServer()
kube.seed("", "v1", "pods", {"metadata": {"name": "p0", "namespace": "ns"}})
proxy = ProxyServer(Options(
    spicedb_endpoint="torch://?device=cpu&cache=1",
    rule_configs=[],
    bootstrap=Bootstrap.from_mapping({"schema":
        "definition user {}\ndefinition pod { relation creator: user\n"
        "permission view = creator }", "relationships":
        "pod:ns/p0#creator@user:ann"}),
    upstream_transport=HandlerTransport(kube)))

async def go():
    out = []
    for _ in range(2):
        ids = await proxy.endpoint.lookup_resources(
            "pod", "view", SubjectRef("user", "ann"))
        out.append([list(ids), ids.source])
    client = proxy.get_embedded_client(user="ann")
    for path in ("/debug/flight", "/debug/timeline", "/debug/workload",
                 "/debug/profile?seconds=0.05"):
        out.append([path, (await client.get(path)).status])
    return out

res = asyncio.run(go())
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"res": res, "modules": loaded}))
"""


def test_cached_endpoint_and_debug_surfaces_run_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _PROBE_CACHE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["res"][:2] == [[["ns/p0"], "kernel"], [["ns/p0"], "cache"]]
    assert [s for _, s in res["res"][2:]] == [200] * 4
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    assert set(TELEMETRY_MODULES) <= set(res["modules"])


def test_no_tpu_figure_in_the_port():
    """The reference's TPU memory rate (819 GB/s) and its v5e figures are
    not the port's: no file of the port quotes them."""
    import re
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        assert not re.search(r"\b819(\.0)?\b", text), path
        assert "v5e" not in text.lower(), path


# the durable store and WAL-shipping replication
DURABLE_MODULES = [
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.persist",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.persist.wal",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.persist.checkpoint",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.persist.manager",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.replication",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.replication.leader",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.replication.follower",
]


@pytest.mark.parametrize("module", DURABLE_MODULES)
def test_durable_module_imports_nothing_forbidden(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert path.exists(), module
    bad = [m for m in _imports(path) if _is_forbidden(m)]
    assert bad == [], f"{module} imports {bad}"


_PROBE_DURABLE = _BLOCK + r"""
import asyncio, json, tempfile
from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
    FakeKubeApiServer)
from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import HandlerTransport
from spicedb_kubeapi_proxy_tpu_torch.proxy.server import Options, ProxyServer
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef
boot = Bootstrap.from_mapping({"schema":
    "definition user {}\ndefinition pod { relation creator: user\n"
    "permission view = creator }", "relationships":
    "pod:ns/p0#creator@user:ann"})
data = tempfile.mkdtemp()
kube = FakeKubeApiServer()

def leader():
    return ProxyServer(Options(
        spicedb_endpoint="torch://?device=cpu", rule_configs=[],
        bootstrap=boot, upstream_transport=HandlerTransport(kube),
        data_dir=data, wal_fsync="always"))

first = leader()
first.persistence.checkpoint()
second = leader()          # recovered: the bootstrap is not applied again
follower = ProxyServer(Options(
    spicedb_endpoint="torch://?device=cpu", rule_configs=[],
    bootstrap=boot, upstream_transport=HandlerTransport(kube),
    replicate_from="http://leader",
    leader_transport=HandlerTransport(second.handler)))

async def go():
    await follower.replication.sync_once()
    return list(await follower.endpoint.lookup_resources(
        "pod", "view", SubjectRef("user", "ann")))

ids = asyncio.run(go())
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"ids": ids, "revisions": [
    first.endpoint.store.revision, second.endpoint.store.revision,
    follower.endpoint.store.revision], "modules": loaded}))
"""


def test_durable_store_and_follower_run_with_jax_blocked():
    """A `torch://?device=cpu` leader with a data dir, its restart on the
    same dir (recovered, bootstrap-once) and a follower bootstrapped
    from its checkpoint, with jax, h11, yaml and cryptography
    unimportable: nothing of the reference is loaded."""
    out = subprocess.run([sys.executable, "-c", _PROBE_DURABLE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ids"] == ["ns/p0"]
    assert res["revisions"] == [1, 1, 1]
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    assert set(DURABLE_MODULES) <= set(res["modules"])


# leader failover
FAILOVER_MODULES = [
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.replication.failover",
    "spicedb_kubeapi_proxy_tpu_torch.utils.failpoints",
]


@pytest.mark.parametrize("module", FAILOVER_MODULES)
def test_failover_module_imports_nothing_forbidden(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    assert path.exists(), module
    bad = [m for m in _imports(path) if _is_forbidden(m)]
    assert bad == [], f"{module} imports {bad}"


_PROBE_FAILOVER = _BLOCK + r"""
import asyncio, json, os, tempfile
from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
    FakeKubeApiServer)
from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import HandlerTransport
from spicedb_kubeapi_proxy_tpu_torch.proxy.server import Options, ProxyServer
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
from spicedb_kubeapi_proxy_tpu_torch.spicedb.replication import failover
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    RelationshipUpdate, SubjectRef, UpdateOp, parse_relationship)
schema = ("definition user {}\ndefinition pod { relation creator: user\n"
          "permission view = creator }")
tmp = tempfile.mkdtemp()
kube = FakeKubeApiServer()
common = dict(spicedb_endpoint="torch://?device=cpu", rule_configs=[],
              upstream_transport=HandlerTransport(kube))
leader = ProxyServer(Options(bootstrap=Bootstrap(
    schema, "pod:ns/p0#creator@user:ann"), data_dir=os.path.join(tmp, "l"),
    wal_fsync="never", **common))

class Link:
    def __init__(self, proxy):
        self.proxy = proxy
    async def round_trip(self, req):
        return await self.proxy.handler(req)

fol = ProxyServer(Options(bootstrap=Bootstrap(schema),
    replicate_from="http://leader", leader_transport=Link(leader),
    promote_data_dir=os.path.join(tmp, "p"), **common))

def touch(s):
    return [RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(s))]

async def go():
    await fol.replication.sync_once()
    await leader.endpoint.write_relationships(touch("pod:ns/p1#creator@user:ann"))
    info = await failover.promote_follower(fol)
    await fol.endpoint.write_relationships(touch("pod:ns/p2#creator@user:ann"))
    leader.opts.replica_peers = ["http://new"]
    leader.opts.peer_transports = {"http://new": Link(fol)}
    state = await failover.FenceMonitor(leader).check_once()
    ids = []
    for p in (fol, leader):
        ids.append(sorted(await p.endpoint.lookup_resources(
            "pod", "view", SubjectRef("user", "ann"))))
    return info["incarnation"], state, ids

inc, state, ids = asyncio.run(go())
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"incarnation": inc, "state": state, "ids": ids,
                  "modules": loaded}))
"""


def test_promotion_and_rejoin_run_with_jax_blocked():
    """A follower promoted over a dead `torch://?device=cpu` leader, and
    the ex-leader fenced and rejoined with its unshipped write, with jax,
    h11, yaml and cryptography unimportable: nothing of the reference is
    loaded."""
    out = subprocess.run([sys.executable, "-c", _PROBE_FAILOVER], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["incarnation"] == 3 and res["state"] == "demoted"
    assert res["ids"] == [["ns/p0", "ns/p1", "ns/p2"]] * 2
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    assert set(FAILOVER_MODULES) <= set(res["modules"])


# tuple-space sharding and the schema lint
SHARDING_MODULES = [
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.sharding",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.sharding.metrics",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.sharding.partition",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.sharding.revvec",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.sharding.router",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.schema_lint",
]


@pytest.mark.parametrize("module", SHARDING_MODULES)
def test_sharding_module_imports_nothing_forbidden(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert path.exists(), module
    bad = [m for m in _imports(path) if _is_forbidden(m)]
    assert bad == [], f"{module} imports {bad}"


_PROBE_SHARDING = _BLOCK + r"""
import asyncio, json, os, tempfile
from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
    FakeKubeApiServer)
from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
    HandlerTransport, Headers, Request)
from spicedb_kubeapi_proxy_tpu_torch.proxy.server import Options, ProxyServer
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
from spicedb_kubeapi_proxy_tpu_torch.spicedb.schema_lint import lint_schema
from spicedb_kubeapi_proxy_tpu_torch.spicedb.sharding import (
    PartitionMap, ShardRouter)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef
schema = ("definition user {}\ndefinition pod { relation creator: user\n"
          "permission view = creator }\ndefinition note {\n"
          "relation creator: user\npermission view = creator }")
kube = FakeKubeApiServer()
kube.seed("", "v1", "pods", {"metadata": {"name": "p0", "namespace": "ns"}})
rule = {"apiVersion": "authzed.com/v1alpha1", "kind": "ProxyRule",
        "metadata": {"name": "list-pods"},
        "match": [{"apiVersion": "v1", "resource": "pods",
                   "verbs": ["list"]}],
        "prefilter": [{"fromObjectIDNamespaceExpr":
                       "{{split_namespace(resourceId)}}",
                       "fromObjectIDNameExpr": "{{split_name(resourceId)}}",
                       "lookupMatchingResources": {
                           "tpl": "pod:$#view@user:{{user.name}}"}}]}
from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
rules = [proxyrule.parse_doc(rule)]
proxy = ProxyServer(Options(
    spicedb_endpoint="torch://?device=cpu", rule_configs=rules,
    bootstrap=Bootstrap(schema, "pod:ns/p0#creator@user:ann\n"
                                "note:n1#creator@user:ann"),
    upstream_transport=HandlerTransport(kube), shards=2,
    partition_map="pod=1", data_dir=tempfile.mkdtemp(), wal_fsync="never"))
router = ShardRouter(PartitionMap.parse("pod=1", n_shards=2),
                     [HandlerTransport(proxy.handler)] * 2,
                     rule_configs=rules)

async def go():
    ids = [sorted(await proxy.endpoint.lookup_resources(
        t, "view", SubjectRef("user", "ann"))) for t in ("pod", "note")]
    resp = await router.handle(Request("GET", "/api/v1/pods", headers=Headers(
        [("X-Remote-User", "ann"), ("Accept", "application/json")])))
    return ids, resp.status, resp.headers.get("X-Authz-Shard"), \
        resp.headers.get("X-Authz-Revision")

ids, status, shard, token = asyncio.run(go())
codes = [f.code for f in lint_schema(proxy.endpoint.schema, rules,
                                     partition_map=proxy.sharding)]
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"ids": ids, "status": status, "shard": shard,
                  "token": token, "codes": codes, "modules": loaded}))
"""


def test_sharded_proxy_router_and_lint_run_with_jax_blocked():
    """A two-shard proxy on `torch://?device=cpu` with a data dir, a
    router in front of it and the schema lint, with jax, h11, yaml and
    cryptography unimportable: nothing of the reference is loaded."""
    out = subprocess.run([sys.executable, "-c", _PROBE_SHARDING], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ids"] == [["ns/p0"], ["n1"]]
    assert (res["status"], res["shard"], res["token"]) == (200, "1",
                                                           "0:1,1:1")
    assert res["codes"] == []
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    assert set(SHARDING_MODULES) <= set(res["modules"])


# the remote endpoint and the fleet plane
REMOTE_FLEET_MODULES = [
    "spicedb_kubeapi_proxy_tpu_torch.permsd",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.wire",
    "spicedb_kubeapi_proxy_tpu_torch.spicedb.grpc_remote",
    "spicedb_kubeapi_proxy_tpu_torch.utils.fleet",
    "spicedb_kubeapi_proxy_tpu_torch.utils.tailexplain",
    "spicedb_kubeapi_proxy_tpu_torch.utils.loadgen",
    "spicedb_kubeapi_proxy_tpu_torch.utils.topology",
]


@pytest.mark.parametrize("module", REMOTE_FLEET_MODULES)
def test_remote_and_fleet_module_imports_nothing_forbidden(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    assert path.exists(), module
    bad = [m for m in _imports(path) if _is_forbidden(m)]
    assert bad == [], f"{module} imports {bad}"


_PROBE_REMOTE_FLEET = _BLOCK + r"""
import asyncio, json
sys.modules["grpc"] = None
from spicedb_kubeapi_proxy_tpu_torch import permsd
from spicedb_kubeapi_proxy_tpu_torch.spicedb import grpc_remote, wire
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef
from spicedb_kubeapi_proxy_tpu_torch.utils import (
    fleet, loadgen, tailexplain, topology)
ep = create_endpoint("torch://?device=cpu", Bootstrap(
    "definition user {}\ndefinition doc { relation viewer: user\n"
    "permission view = viewer }", "doc:d1#viewer@user:ann"))
_, lookup = grpc_remote.PermissionsGrpcServer(ep).handlers()[
    "/authzed.api.v1.PermissionsService/LookupResources"]

async def go():
    return [wire.dec_lookup_response(f)[0] async for f in lookup(
        wire.enc_lookup_request("doc", "view", SubjectRef("user", "ann")),
        None)]

ids = asyncio.run(go())
merged = fleet.merge_fleet([{"url": "a", "traces": []}])
report = tailexplain.explain(merged)
lines = loadgen.WorkloadSpec(duration_s=0.5).schedule_lines()
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"ids": ids, "traces": merged["traces"],
                  "requests": report["requests"], "lines": len(lines),
                  "modules": loaded}))
"""


def test_remote_and_fleet_run_with_jax_grpc_and_yaml_blocked():
    """permsd's handlers over `torch://?device=cpu`, the fleet merge, the
    tail report and the workload schedule, with jax, grpc, h11, yaml and
    cryptography unimportable: nothing of the reference is loaded."""
    out = subprocess.run([sys.executable, "-c", _PROBE_REMOTE_FLEET],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ids"] == ["d1"] and res["traces"] == []
    assert res["requests"] == 0 and res["lines"] > 0
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    assert set(REMOTE_FLEET_MODULES) <= set(res["modules"])


# the last two modules: the native bulk parser and the process-group glue
NATIVE_DIST_MODULES = [
    "spicedb_kubeapi_proxy_tpu_torch.native",
    "spicedb_kubeapi_proxy_tpu_torch.parallel.distributed",
]


@pytest.mark.parametrize("module", NATIVE_DIST_MODULES)
def test_native_and_distributed_import_nothing_forbidden(module):
    rel = module.replace(".", "/")
    path = ROOT / (rel + ".py")
    if not path.exists():
        path = ROOT / rel / "__init__.py"
    assert path.exists(), module
    bad = [m for m in _imports(path) if _is_forbidden(m)]
    assert bad == [], f"{module} imports {bad}"


_PROBE_NATIVE_DIST = _BLOCK + r"""
import json
from spicedb_kubeapi_proxy_tpu_torch import native
from spicedb_kubeapi_proxy_tpu_torch.parallel import distributed
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, EndpointConfigError, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.store import TupleStore
store = TupleStore()
store.bulk_load_text("doc:d1#viewer@user:ann\ndoc:d2#viewer@user:bob")
try:
    create_endpoint("torch://?distributed=bogus&device=cpu")
    refused = False
except EndpointConfigError:
    refused = True
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"n": len(store.read(None)), "refused": refused,
                  "up": distributed.is_initialized(), "modules": loaded}))
"""


def test_native_parse_and_distributed_glue_run_with_jax_blocked():
    """A bulk load through the native parser and the `distributed=`
    parsing, with jax, h11, yaml and cryptography unimportable."""
    out = subprocess.run([sys.executable, "-c", _PROBE_NATIVE_DIST],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] == 2 and res["refused"] and not res["up"]
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    assert set(NATIVE_DIST_MODULES) <= set(res["modules"])


# the port's own fuzz harness and its command line
FUZZ_MODULES = [
    "spicedb_kubeapi_proxy_tpu_torch.fuzz",
    "spicedb_kubeapi_proxy_tpu_torch.fuzz.schema_gen",
    "spicedb_kubeapi_proxy_tpu_torch.fuzz.delta_gen",
    "spicedb_kubeapi_proxy_tpu_torch.fuzz.scenarios",
    "spicedb_kubeapi_proxy_tpu_torch.fuzz.metrics",
    "spicedb_kubeapi_proxy_tpu_torch.fuzz.driver",
    "spicedb_kubeapi_proxy_tpu_torch.fuzz.shrink",
    "spicedb_kubeapi_proxy_tpu_torch.fuzz.mutations",
    "spicedb_kubeapi_proxy_tpu_torch.fuzz.__main__",
]


@pytest.mark.parametrize("module", FUZZ_MODULES)
def test_fuzz_module_imports_nothing_forbidden(module):
    rel = module.replace(".", "/")
    path = ROOT / (rel + ".py")
    if not path.exists():
        path = ROOT / rel / "__init__.py"
    assert path.exists(), module
    bad = [m for m in _imports(path) if _is_forbidden(m)]
    assert bad == [], f"{module} imports {bad}"


_PROBE_FUZZ = _BLOCK + r"""
import json, runpy
sys.argv = ["spicedb_kubeapi_proxy_tpu_torch.fuzz", "--device", "cpu",
            "--seeds", "3"]
try:
    runpy.run_module("spicedb_kubeapi_proxy_tpu_torch.fuzz",
                     run_name="__main__", alter_sys=True)
    code = 0
except SystemExit as e:
    code = e.code
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None)
print(json.dumps({"code": code, "modules": loaded}))
"""


def test_fuzz_command_runs_with_jax_blocked():
    """`python -m spicedb_kubeapi_proxy_tpu_torch.fuzz --device cpu`
    replays fixed cells with jax, h11, yaml and cryptography
    unimportable, and loads nothing of the reference."""
    out = subprocess.run([sys.executable, "-c", _PROBE_FUZZ], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["code"] == 0, out.stdout
    assert "fuzz: 3 fixed cells agree" in out.stdout
    assert not [m for m in res["modules"] if _is_forbidden(m)]
    # runpy runs the command line as `__main__`
    main = "spicedb_kubeapi_proxy_tpu_torch.fuzz.__main__"
    assert set(FUZZ_MODULES) - {main} <= set(res["modules"])
