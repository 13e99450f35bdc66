"""Entry points of the torch port (the counterpart of the repository's
`__graft_entry__.py`: `entry()` at :49-107, `dryrun_multichip(n)` at
:131-286).

- `entry()`               -> (fn, example_args): one forward step of the
  segment kernel (batched LookupResources over a small multi-tenant
  graph) on the card, or on the CPU with `device="cpu"`.
- `dryrun_multichip(n)`   -> builds an n-device (data x graph) mesh over
  the visible cards (cuda:0 repeated when fewer are visible), runs the
  sharded ELL and segment kernels and `torch://?mesh=...&dispatch=direct`
  with a delta on it, each held against the host oracle.

    python -m spicedb_kubeapi_proxy_tpu_torch.entry 8
"""

from __future__ import annotations

import sys
from typing import Optional

_DEMO_SCHEMA = """
definition user {}
definition group { relation member: user | group#member }
definition tenant {
  relation admin: user
  relation member: user | group#member
  permission access = admin + member
}
definition namespace {
  relation tenant: tenant
  relation viewer: user | group#member
  permission view = viewer + tenant->access
}
definition pod {
  relation namespace: namespace
  relation creator: user
  relation banned: user
  permission view = creator + namespace->view - banned
}
"""

QUERY_LANES = 16


def _build_program(n_users=24, n_groups=6, n_tenants=2, n_ns=4, n_pods=32,
                   seed=0):
    """The reference's demo graph, tuple for tuple (the same
    `random.Random(seed)` draws): (GraphProgram, schema, store)."""
    import random

    from .ops.graph_compile import compile_graph
    from .spicedb import schema as sch
    from .spicedb.store import TupleStore
    from .spicedb.types import parse_relationship

    rng = random.Random(seed)
    rels = set()
    for u in range(n_users):
        rels.add(f"group:g{rng.randrange(n_groups)}#member@user:u{u}")
    for g in range(n_groups):
        rels.add(f"tenant:t{g % n_tenants}#member@group:g{g}#member")
        if g % 2 == 0 and g + 1 < n_groups:
            rels.add(f"group:g{g+1}#member@group:g{g}#member")
    for t in range(n_tenants):
        rels.add(f"tenant:t{t}#admin@user:u{rng.randrange(n_users)}")
    for ns in range(n_ns):
        rels.add(f"namespace:ns{ns}#tenant@tenant:t{ns % n_tenants}")
    for p in range(n_pods):
        ns = p % n_ns
        rels.add(f"pod:ns{ns}/p{p}#namespace@namespace:ns{ns}")
        if rng.random() < 0.3:
            rels.add(f"pod:ns{ns}/p{p}#creator@user:u{rng.randrange(n_users)}")
    schema = sch.parse_schema(_DEMO_SCHEMA)
    store = TupleStore()
    store.bulk_load([parse_relationship(r) for r in sorted(rels)])
    prog = compile_graph(schema, store.read(None))
    return prog, schema, store


def entry(device: Optional[str] = None):
    """One forward step of the segment kernel and its example args.

    `fn(q_idx, edge_src, edge_dst)` seeds one lane per query and runs
    the segment sweep (ops/spmv.py, hand-written CUDA kernels on the card)
    for the reference's fixed iteration count, `suggested_iterations + 4`,
    with no early exit, then reads the `pod#view` slice with `lookup_T`:
    float32 [pod#view rows, len(q_idx)], 1.0 where the query's subject may
    view the pod — the reference's `fn` output."""
    import numpy as np
    import torch

    from .device import resolve_device
    from .ops import kernels
    from .ops.spmv import KernelCache, pad_edges

    dev = resolve_device(device)
    prog, _, _ = _build_program()
    num_iters = prog.suggested_iterations + 4
    kc = KernelCache(prog, dev, num_iters=num_iters)
    off, ln = prog.slot_range("pod", "view")

    def fn(q_idx, edge_src, edge_dst):
        n_words = (len(q_idx) + 31) // 32
        arena = kc.take_arena(n_words)
        try:
            x0, live = kc.init_state(q_idx, n_words, out=arena.x0)
            x, y = arena.a, arena.b
            x.copy_(x0)
            steps = list(kc.sweep_steps(edge_src, edge_dst))
            for _ in range(num_iters):
                for step in steps:
                    kc.run_step(step, y, x, x0, live)
                x, y = y, x
            words = kernels.lookup_T(x, off, ln)    # int32 [n_words, ln]
            shifts = torch.arange(32, dtype=torch.int32, device=words.device)
            bits = (words.unsqueeze(-1) >> shifts) & 1  # [n_words, ln, 32]
            out = bits.permute(1, 0, 2).reshape(ln, n_words * 32)
            return out[:, :len(q_idx)].to(torch.float32)
        finally:
            kc.put_arena(n_words, arena)

    src, dst = pad_edges(prog)
    q = np.full(QUERY_LANES, prog.dead_index, np.int32)
    for i in range(QUERY_LANES):
        idx = prog.subject_index("user", f"u{i}")
        if idx is not None:
            q[i] = idx
    args = tuple(torch.from_numpy(a).to(dev) for a in (q, src, dst))
    return fn, args


def _mesh_devices(n_devices: int, device: Optional[str]) -> list:
    """n devices: the visible cards, cuda:0 repeated when fewer are
    visible; every shard on the CPU for `device="cpu"`."""
    import torch

    from .device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n_devices
    visible = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())][:n_devices]
    return visible + [torch.device("cuda", 0)] * (n_devices - len(visible))


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> dict:
    """Run the sharded kernels and a mesh endpoint over an n-device mesh
    on the demo graph, each held against the host oracle:

    - ShardedEllKernel: bit-packed fixed-fanin tables, batch words
      sharded over `data`, table rows over `graph`;
    - ShardedKernel: the segment sweep sharded over edges, its replicas
      OR-combined each sweep;
    - `torch://?mesh=DxG&dispatch=direct`: a batched lookup, then a
      delta absorbed without a rebuild and a check that sees it.

    Returns what it measured (the mesh, the allowed bits)."""
    import asyncio

    import numpy as np

    from .ops.torch_endpoint import _ShardedEllGraph
    from .parallel.sharding import ShardedEllKernel, ShardedKernel, make_mesh
    from .spicedb.endpoints import Bootstrap, create_endpoint
    from .spicedb.evaluator import Evaluator
    from .spicedb.types import (
        CheckRequest,
        ObjectRef,
        RelationshipUpdate,
        SubjectRef,
        UpdateOp,
        parse_relationship,
    )

    devices = _mesh_devices(n_devices, device)
    mesh = make_mesh(devices)
    prog, schema, store = _build_program()
    oracle = Evaluator(schema, store)
    subjects = [f"u{i}" for i in range(8)]
    q = np.asarray([prog.subject_index("user", s) for s in subjects],
                   np.int32)
    off, ln = prog.slot_range("pod", "view")
    ids = prog.object_ids["pod"]
    want_sets = [set(oracle.lookup_resources("pod", "view",
                                             SubjectRef("user", u)))
                 for u in subjects]

    def check(ok: bool, message: str) -> None:
        # raised, not asserted: the run must fail under `python -O` too
        if not ok:
            raise AssertionError(message)

    def agree(bitmap, label: str) -> None:
        check(bitmap.shape == (ln, len(subjects)),
              f"{label} bitmap {bitmap.shape}")
        for col, (user, want) in enumerate(zip(subjects, want_sets)):
            got = {ids[i] for i in np.nonzero(bitmap[:, col])[0]}
            check(got == want, f"{label}/oracle mismatch for {user}: "
                               f"{got} != {want}")

    ell = ShardedEllKernel(prog, mesh)
    bitmap = ell.lookup(off, ln, q)
    agree(bitmap, "ell sharded")
    kernel = ShardedKernel(prog, mesh)
    edge_src, edge_dst = kernel.device_edges()
    agree(kernel.lookup(off, ln, q, edge_src, edge_dst), "segment sharded")

    # the endpoint over the mesh: the URL builds it where the cards (or
    # the CPU) hold every shard; cuda:0 repeated is passed as the mesh
    d, g = mesh.shape["data"], mesh.shape["graph"]
    on_cpu = devices[0].type == "cpu"
    url = f"torch://?mesh={d}x{g}&dispatch=direct"
    kw = {}
    if on_cpu:
        url += "&device=cpu"
    elif len(set(devices)) < n_devices:
        kw["mesh"] = mesh
    ep = create_endpoint(url, Bootstrap(schema_text=_DEMO_SCHEMA), **kw)
    ep.store.bulk_load(store.read(None))
    ep.force_rebuild()
    check(isinstance(ep._graph, _ShardedEllGraph),
          f"{url} built {type(ep._graph).__name__}")

    async def drive():
        got = await ep.lookup_resources_batch(
            "pod", "view", [SubjectRef("user", u) for u in subjects])
        for user, want, ids_got in zip(subjects, want_sets, got):
            check(set(ids_got) == want, f"endpoint mismatch for {user}")
        # an incremental delta on the sharded tables (no rebuild)
        rebuilds = ep.stats["rebuilds"]
        rel = parse_relationship("pod:ns0/p0#creator@user:u1")
        ep.store.write([RelationshipUpdate(UpdateOp.TOUCH, rel)])
        res = await ep.check_permission(CheckRequest(
            ObjectRef("pod", "ns0/p0"), "view", SubjectRef("user", "u1")))
        check(res.allowed and ep.stats["rebuilds"] == rebuilds,
              "the delta was not absorbed in place")
        ep.store.write([RelationshipUpdate(UpdateOp.DELETE, rel)])

    asyncio.run(drive())
    out = {"mesh": dict(mesh.shape), "devices": [str(x) for x in devices],
           "state": prog.state_size, "edges": len(prog.edge_src),
           "allowed_bits": int(bitmap.sum())}
    print(f"dryrun_multichip: mesh={out['mesh']} on {out['devices']} "
          f"state={out['state']} edges={out['edges']} "
          f"allowed_bits={out['allowed_bits']} (ell + segment + torch:// "
          f"mesh endpoint with a delta) oracle-verified ok")
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
