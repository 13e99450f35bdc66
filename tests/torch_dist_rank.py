"""One rank of a mesh across processes, and the helpers that spawn ranks
and replay the same sequence in one process: for
tests/test_torch_distributed.py (gloo on the CPU) and the card test in
tests/test_torch_kernels_cuda.py (NCCL, a card a rank).

    SPICEDB_TPU_COORDINATOR=127.0.0.1:<port> SPICEDB_TPU_NUM_PROCESSES=<n> \
    SPICEDB_TPU_PROCESS_ID=<rank> python tests/torch_dist_rank.py SPEC OUT

SPEC is a JSON file (`make_spec`): `mesh` ("DxG"), `device` ("cpu" or
"cuda"), `schema`, `rels`, `rtype`, `perm`, `subjects`, `checks`
([object, subject index]), `writes` ([op, relationship]), `kernel` (`q`,
`gi`, `gc`, `n_words`) and optionally `segment` (`q`, `gi`, `gc`).  A
rank asks for `torch://?distributed=1&mesh=...` with Leopard on, with the
default batching dispatcher and with `cache=1` (each refused, the
message recorded), then serves it with `dispatch=direct` on the
spec's device (every rank sends the same requests in the same order),
reads, applies the writes, reads again, then runs a ShardedEllKernel of
the plainly compiled program on a process mesh with the spec's query
columns (and a ShardedKernel with `segment`'s).  OUT gets this rank's
answers, sweep traces and collective counters as JSON.
`drive_in_process` runs the same sequence with every shard in one
process on the CPU.  Imports the port only.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402


def make_spec(schema: str, rels: list, rtype: str, perm: str,
              subjects: list, writes: list, mesh: str,
              n_objs: int = 60) -> dict:
    """A spec over the plainly compiled program: checks of the first
    `n_objs` objects of `rtype`, seeded query columns and gather pairs
    for the kernels alone (the segment sweep's too when the program has
    no caveats)."""
    from spicedb_kubeapi_proxy_tpu_torch.ops.graph_compile import (
        compile_graph)
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import (
        padded_batch_words_for)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as sch
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        parse_relationship)
    prog = compile_graph(sch.parse_schema(schema),
                         [parse_relationship(r) for r in rels])
    objs = [o for o in prog.object_ids[rtype] if "\x00" not in o][:n_objs]
    d = int(mesh.split("x")[0])
    rng = np.random.default_rng(len(rels) + d)
    lanes = 40
    n_words = padded_batch_words_for(d, lanes)
    q = np.full(32 * n_words, prog.dead_index, np.int32)
    q[:lanes] = rng.integers(0, prog.dead_index, lanes)
    spec = {"mesh": mesh, "schema": schema, "rels": list(rels),
            "rtype": rtype, "perm": perm, "subjects": list(subjects),
            "checks": [[o, i % len(subjects)] for i, o in enumerate(objs)],
            "writes": [list(wr) for wr in writes],
            "kernel": {"q": q.tolist(),
                       "gi": rng.integers(0, prog.state_size, 200).tolist(),
                       "gc": rng.integers(0, lanes, 200).tolist(),
                       "n_words": int(n_words)}}
    if not len(prog.cav_src):
        spec["segment"] = {
            "q": rng.integers(0, prog.dead_index, 37).tolist(),
            "gi": rng.integers(0, prog.state_size, 150).tolist(),
            "gc": rng.integers(0, 37, 150).tolist()}
    return spec


def drive(spec: dict, url: str, kernel_mesh) -> dict:
    """The spec's sequence on the endpoint `url` (built with
    leopard=False, rebuilding synchronously), then the kernels alone on
    the mesh `kernel_mesh()` returns (made after the endpoint's reads):
    answers, sweep traces, lookup words and checks."""
    from spicedb_kubeapi_proxy_tpu_torch.ops.graph_compile import (
        compile_graph)
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import (
        ShardedEllKernel, ShardedKernel)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as sch
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)
    from spicedb_kubeapi_proxy_tpu_torch.utils import features

    features.ASYNC_REBUILD = False
    ep = create_endpoint(url, Bootstrap(spec["schema"],
                                        "\n".join(spec["rels"])),
                         leopard=False)
    subs = [SubjectRef("user", u) for u in spec["subjects"]]
    reqs = [CheckRequest(ObjectRef(spec["rtype"], o), spec["perm"], subs[i])
            for o, i in spec["checks"]]

    def reads() -> dict:
        look = asyncio.run(ep.lookup_resources_batch(spec["rtype"],
                                                     spec["perm"], subs))
        trace_l = ep.graph().kernel.last_trace.tolist()
        chk = asyncio.run(ep.check_bulk_permissions(reqs))
        trace_c = ep.graph().kernel.last_trace.tolist()
        return {"lookups": [sorted(x) for x in look],
                "checks": [c.permissionship.name for c in chk],
                "trace_l": trace_l, "trace_c": trace_c}

    out = {"mesh": repr(ep.mesh), "reads": [reads()]}
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    asyncio.run(ep.write_relationships(
        [RelationshipUpdate(ops[o], parse_relationship(r))
         for o, r in spec["writes"]]))
    out["reads"].append(reads())
    out["rebuilds"] = ep.stats["rebuilds"]
    out["planes"] = bool(ep.graph().kernel.planes)
    del ep

    k = spec["kernel"]
    prog = compile_graph(sch.parse_schema(spec["schema"]),
                         [parse_relationship(r) for r in spec["rels"]])
    mesh = kernel_mesh()
    kern = ShardedEllKernel(prog, mesh)
    q = np.asarray(k["q"], np.int32)
    off, length = prog.slot_range(spec["rtype"], spec["perm"])
    tables = kern.snapshot_tables()
    words, tl = kern.lookup_packed_T_device(off, length, q, k["n_words"],
                                            *tables)
    chk, tc = kern.checks_device(q, k["n_words"],
                                 np.asarray(k["gi"], np.int32),
                                 np.asarray(k["gc"], np.int32), *tables)
    out["kernel"] = {
        "words": words.cpu().numpy().view(np.uint32).ravel().tolist(),
        "checks": chk.cpu().numpy().view(np.uint32).tolist(),
        "trace_l": np.asarray(tl).tolist(), "trace_c": np.asarray(tc).tolist(),
        "local_shards": sum(1 for row in kern.idx_main for t in row
                            if t is not None)}
    if "segment" in spec:
        # the edge-sharded segment sweep and its OR all-reduce
        sk = ShardedKernel(prog, mesh)
        src, dst = sk.device_edges()
        sq = np.asarray(spec["segment"]["q"], np.int32)
        out["segment"] = {
            "lookup": np.asarray(sk.lookup(off, length, sq, src, dst))
            .tolist(),
            "checks": np.asarray(sk.checks(
                sq, np.asarray(spec["segment"]["gi"], np.int32),
                np.asarray(spec["segment"]["gc"], np.int32), src, dst))
            .tolist(),
            "trace": np.asarray(sk.last_trace).tolist()}
    return out


def drive_in_process(spec: dict) -> dict:
    """`drive` on `torch://?mesh=...&device=cpu`: every shard in this
    process, on the CPU."""
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import make_mesh
    d, g = (int(v) for v in spec["mesh"].split("x"))
    return drive(spec, f"torch://?mesh={spec['mesh']}&device=cpu"
                       f"&dispatch=direct",
                 lambda: make_mesh(["cpu"] * (d * g), data=d, graph=g))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(spec: dict, n: int, tmp, device: str = "cpu",
          timeout: float = 110.0) -> list:
    """Run this script as `n` ranks of one process group (rank r on card
    r with device="cuda") and return their outputs in rank order.  A
    rank that fails raises RuntimeError with its output; ranks that
    outlive `timeout` are killed and raise TimeoutError."""
    tmp = Path(tmp)
    spec = dict(spec, device=device)
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, SPICEDB_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   SPICEDB_TPU_NUM_PROCESSES=str(n),
                   SPICEDB_TPU_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="1")
        # a rank still running 10 s before the deadline prints its stacks
        env["RANK_STACKS_AFTER_S"] = str(max(1.0, timeout - 10))
        if device == "cuda":
            env["LOCAL_RANK"] = str(r)
        else:
            env.pop("LOCAL_RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(spec_path),
             str(tmp / f"out{r}.json")], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            left = max(0.1, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [logs[r] if r < len(logs) else p.communicate()[0]
                for r, p in enumerate(procs)]
        tails = [(r, p.returncode, outs[r][-3000:])
                 for r, p in enumerate(procs)]
        raise TimeoutError(f"{n} ranks did not finish in {timeout:g} s: "
                           f"{tails}")
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs)
           if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks failed: {bad}")
    return [json.loads((tmp / f"out{r}.json").read_text()) for r in range(n)]


def main(spec_path: str, out_path: str) -> int:
    stacks_after = float(os.environ.get("RANK_STACKS_AFTER_S", "0"))
    if stacks_after:
        import faulthandler
        faulthandler.dump_traceback_later(stacks_after, exit=False)
    with open(spec_path) as f:
        spec = json.load(f)
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.parallel import (collectives,
                                                          distributed)
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import (
        make_process_mesh)

    dev = spec["device"]
    url = (f"torch://?distributed=1&mesh={spec['mesh']}&dispatch=direct"
           + ("&device=cpu" if dev == "cpu" else ""))
    d, g = (int(v) for v in spec["mesh"].split("x"))
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, EndpointConfigError, create_endpoint)
    # what would let the ranks' collectives diverge is refused: the
    # Leopard index, the batching dispatcher (the default without
    # dispatch=direct) and the decision cache
    refused = {}
    for what, u, leopard in (
            ("leopard", url, True),
            ("dispatch", url.replace("&dispatch=direct", ""), False),
            ("cache", url + "&cache=1", False)):
        try:
            create_endpoint(u, Bootstrap(spec["schema"]), leopard=leopard)
            refused[what] = ""
        except EndpointConfigError as e:
            refused[what] = str(e)
    collectives.reset_collectives()
    kernels.reset_launches()
    out = drive(spec, url, lambda: make_process_mesh(
        d, g, device=None if dev == "cuda" else dev))
    out.update(rank=distributed.world()[0], world=distributed.world()[1],
               refused=refused)
    out["collectives"] = {n: dict(c) for n, c in
                          collectives.COLLECTIVES.items()}
    out["launches"] = {n: v for n, v in kernels.LAUNCHES.items() if v}
    distributed.destroy()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
