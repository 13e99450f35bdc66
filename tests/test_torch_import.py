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
