"""Multitenant-1m on a mesh across processes: four ranks, a card each.

    python3 scripts/torch_distributed_phase.py [--mesh 1x4] [--ranks 4]

Spawns `--ranks` processes of this script (one NCCL process group over a
loopback coordinator, rank r on card r); each serves multitenant-1m at
its defaults behind `torch://?distributed=1&mesh=DxG&dispatch=direct`
(leopard off, as a mesh across processes requires) and drives smoke
phases 4-5's batches (`chip_smoke.drive`: 1 + N_WARM lookup batches of
256 subjects and as many check batches of 10,000 pairs).  Each rank then
times one sweep's graph-axis exchange (the all_gather_rows calls of
`ShardedEllKernel.sweep_calls`), the sweep's delta all-reduce with its
readback, and the whole sweep, CUDA events on its card, and counts the
bytes that arrived from other ranks against `sharding.comm_model`.
After the ranks exit, this process serves the same store behind the
single-process `torch://?mesh=DxG&dispatch=direct` on the same cards
(smoke phase 13's path), drives the same batches and times the same
parts.  Answers are compared by digest.  Prints every rank's log, one
JSON summary line (also written to chiprun_out/distributed_phase.json)
and the card's name and power limit; exits non-zero on a failed rank,
a disagreement, or fewer cards than ranks.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
RANK_TIMEOUT_S = 600


# `--rehearse`: every rank and the single process on the CPU (gloo) at a
# small size, to try the script without cards
SMALL = dict(n_pods=20_000, n_tuples=60_000, n_users=1_000,
             n_namespaces=200)


def _digest(lookups, checks) -> str:
    h = hashlib.sha256()
    for batch in lookups:
        for ids in batch:
            h.update(("\x1f".join(sorted(ids)) + "\x1e").encode())
    for batch in checks:
        h.update("".join(c.permissionship.name[0] for c in batch).encode())
    return h.hexdigest()


def _serve_and_time(url: str, w, mesh_dg: tuple, smoke) -> dict:
    """Build `url` on multitenant-1m, drive phases 4-5's batches, time a
    sweep's exchange, its reduce and the whole sweep."""
    import statistics

    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import comm_model
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)

    t0 = time.perf_counter()
    ep = create_endpoint(url, Bootstrap(w.schema_text,
                                        "\n".join(w.relationships)),
                         leopard=False)
    g = ep.graph()
    kern = g.kernel
    dev = kern.mesh.devices[0][0]
    timer = smoke.Timer(torch, dev)
    t_build = time.perf_counter() - t0
    kernels.reset_launches()
    collectives.reset_collectives()
    batches, lookups, reqs, checks, summary = smoke.drive(ep, w, timer)
    coll = {k: dict(v) for k, v in collectives.COLLECTIVES.items()}
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    sweeps = sum(sum(s["sweeps"]) for s in summary.values())
    d, gg = mesh_dg
    cm = comm_model(g.prog.state_size, kern.a_pad, d, gg,
                    smoke.LOOKUP_LANES, aux_passes=kern.aux_passes)

    # one sweep, its parts apart, on the state after a seed
    q_arr, _, _ = ep._encode_subjects(g, batches[0])
    n_words = len(q_arr) // 32
    tables = g.snapshot()
    ar = kern._alloc_arenas(n_words)
    x0, live = kern.seed(q_arr, n_words, ar)
    pick = lambda f: [[f(a) if a is not None else None for a in row]
                      for row in ar]
    cur, aux = pick(lambda a: a.b), pick(lambda a: a.aux)
    calls = kern.sweep_calls(cur, x0, x0, live, aux, tables, n_words)
    exchange = [f for name, f in calls if name == "all_gather_rows"]
    n_data = kern.mesh.shape["data"]
    deltas = {dv: torch.zeros((1, n_data + 1, 2), dtype=torch.int32,
                              device=dv) for dv in kern._placement}
    slots_of = {k: t[0] for k, t in deltas.items()}
    across = kern.mesh.spans_processes

    def reduce():
        slots = kern.sweep_deltas(cur, x0, slots_of)
        collectives.reduce_data_deltas(deltas[dev][0][:n_data], slots,
                                       across=across)

    def sweep():
        kern.step(cur, x0, x0, live, aux, tables, n_words)
        reduce()

    before = {k: dict(v) for k, v in collectives.COLLECTIVES.items()}
    ex_ms = timer.ms(lambda: [f(kernels) for f in exchange])
    after = collectives.COLLECTIVES["all_gather_rows"]
    ex_calls = after["calls"] - before["all_gather_rows"]["calls"]
    ex_x = after["xrank_bytes"] - before["all_gather_rows"]["xrank_bytes"]
    red_ms = timer.ms(reduce)
    sweep_ms = timer.ms(sweep)
    med = {v: statistics.median(s["e2e_s"][1:]) for v, s in summary.items()}
    return {
        "url": url, "mesh": repr(kern.mesh), "build_s": t_build,
        "lookup_e2e_s": summary["lookup"]["e2e_s"],
        "check_e2e_s": summary["check"]["e2e_s"],
        "lookup_warm_median_s": med["lookup"],
        "check_warm_median_s": med["check"],
        "sweeps": {v: s["sweeps"] for v, s in summary.items()},
        "launches": launches, "collectives": coll,
        "exchange_ms_per_sweep": ex_ms,
        "exchange_calls_per_sweep": len(exchange),
        "exchange_xrank_bytes_per_sweep": (ex_x / max(1, ex_calls)
                                           * len(exchange)),
        "served_xrank_bytes_per_sweep":
            coll["all_gather_rows"]["xrank_bytes"] / max(1, sweeps),
        "comm_model_recv_bytes_per_device_per_sweep":
            cm["all_gather_recv_bytes_per_device_per_iter"],
        "reduce_ms_per_sweep": red_ms, "sweep_ms": sweep_ms,
        "digest": _digest(lookups, checks)}


def rank_main(out_path: str, mesh: str, rehearse: bool) -> int:
    import torch
    import torch.distributed as tdist

    import chip_smoke as smoke
    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.parallel import distributed

    if not rehearse:
        kernels.build()
        kernels._load()
    smoke._switch(False)
    w = workloads.multitenant_1m(**(SMALL if rehearse else {}))
    d, g = (int(v) for v in mesh.split("x"))
    out = _serve_and_time(f"torch://?distributed=1&mesh={mesh}"
                          f"&dispatch=direct"
                          + ("&device=cpu" if rehearse else ""), w, (d, g),
                          smoke)
    out.update(rank=distributed.world()[0], world=distributed.world()[1],
               card="cpu" if rehearse else str(torch.device(
                   "cuda", torch.cuda.current_device())),
               backend=tdist.get_backend())
    distributed.destroy()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1x4")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--rank-out")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()
    if args.rank_out:
        return rank_main(args.rank_out, args.mesh, args.rehearse)
    if not args.rehearse and (not torch.cuda.is_available() or
                              torch.cuda.device_count() < args.ranks):
        print(f"torch_distributed_phase: needs {args.ranks} CUDA cards",
              file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels

    if args.rehearse:
        smi = "cpu rehearsal"
    else:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        smi = smi.splitlines()[0]       # a line a card, all alike
        kernels.build()         # once, before the ranks load it
    print(smi, flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs, logs = [], []
    for r in range(args.ranks):
        env = dict(os.environ, SPICEDB_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   SPICEDB_TPU_NUM_PROCESSES=str(args.ranks),
                   SPICEDB_TPU_PROCESS_ID=str(r), LOCAL_RANK=str(r))
        log = open(os.path.join(out_dir, f"dist_rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh", args.mesh,
             "--rank-out", os.path.join(out_dir, f"dist_rank{r}.json")]
            + (["--rehearse"] if args.rehearse else []),
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(1, RANK_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
    for log in logs:
        log.close()
    for r in range(args.ranks):
        with open(os.path.join(out_dir, f"dist_rank{r}.log")) as f:
            text = f.read()
        print(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
              + text[-4000:], flush=True)
    if any(p.returncode != 0 for p in procs):
        return 1
    ranks = []
    for r in range(args.ranks):
        with open(os.path.join(out_dir, f"dist_rank{r}.json")) as f:
            ranks.append(json.load(f))
    t_ranks = time.perf_counter() - t0
    # the single-process mesh on the same cards, the same batches
    smoke._switch(False)
    w = workloads.multitenant_1m(**(SMALL if args.rehearse else {}))
    d, g = (int(v) for v in args.mesh.split("x"))
    one = _serve_and_time(f"torch://?mesh={args.mesh}&dispatch=direct"
                          + ("&device=cpu" if args.rehearse else ""), w,
                          (d, g), smoke)
    same = all(r["digest"] == one["digest"] for r in ranks)
    summary = {"card": smi, "mesh": args.mesh, "ranks_s": t_ranks,
               "answers_equal": same, "ranks": ranks, "single_process": one}
    with open(os.path.join(out_dir, "distributed_phase.json"), "w") as f:
        json.dump(summary, f)
    for r in ranks:
        print(f"rank {r['rank']} on {r['card']} ({r['backend']}): warm "
              f"median lookup {r['lookup_warm_median_s']:.6f} s, check "
              f"{r['check_warm_median_s']:.6f} s; sweeps {r['sweeps']}; "
              f"exchange {r['exchange_ms_per_sweep']:.6f} ms a sweep "
              f"({r['exchange_calls_per_sweep']} all_gather_rows calls, "
              f"{r['exchange_xrank_bytes_per_sweep']:.0f} bytes from other "
              f"ranks; served batches "
              f"{r['served_xrank_bytes_per_sweep']:.0f} a sweep; comm_model "
              f"{r['comm_model_recv_bytes_per_device_per_sweep']}); delta "
              f"all-reduce + readback {r['reduce_ms_per_sweep']:.6f} ms; "
              f"whole sweep {r['sweep_ms']:.6f} ms ({smi})", flush=True)
    print(f"single process {one['mesh']}: warm median lookup "
          f"{one['lookup_warm_median_s']:.6f} s, check "
          f"{one['check_warm_median_s']:.6f} s; exchange "
          f"{one['exchange_ms_per_sweep']:.6f} ms a sweep (copies between "
          f"cards); readback {one['reduce_ms_per_sweep']:.6f} ms; whole "
          f"sweep {one['sweep_ms']:.6f} ms ({smi})", flush=True)
    print(f"answers equal across the ranks and the single process: {same}",
          flush=True)
    print(json.dumps({k: v for k, v in summary.items() if k != "ranks"}
                     | {"rank0": ranks[0]}))
    print(smi)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
