"""Card run of chip_smoke.py's phases 22 and 23 alone.

    python3 scripts/torch_remote_fleet_phases.py      (one CUDA card)

Builds the kernels and makes multitenant-1m at its defaults; runs phase
16 (`chip_smoke.proxy_path`, the proxy whose batched endpoint phase 22
serves) and then phase 22 (`chip_smoke.remote_path`, the remote endpoint
over gRPC or in-process); then phase 21's (a)-(f) keeping its lineages
(`chip_smoke.shard_path(..., keep=True)`) and phase 23
(`chip_smoke.fleet_path`, the shard leaders and the router as processes
under open-loop traffic), every check of the whole smoke's run of them
included.  Prints whether grpcio imports, the phases' log lines, their
seconds and their launches by kernel; exits non-zero on a failed check
and without a card.
"""

import gc
import os
import shutil
import subprocess
import sys
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_remote_fleet_phases: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as smoke
    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"grpc transport: {smoke._grpc_transport()}; python "
          f"{sys.version.split()[0]}, torch {torch.__version__}", flush=True)
    t = time.perf_counter()
    kernels.build()
    kernels._load()
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    w = workloads.multitenant_1m()
    t = time.perf_counter()
    p16 = smoke.proxy_path(w, smi)
    t16 = time.perf_counter() - t
    t = time.perf_counter()
    remote = smoke.remote_path(p16, smi)
    t22 = time.perf_counter() - t
    del p16
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    sharded = smoke.shard_path(w, smi, keep=True)
    t21 = time.perf_counter() - t
    f21 = sharded.pop("fleet")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    try:
        fleet = smoke.fleet_path(f21, smi)
    finally:
        shutil.rmtree(f21["tmp"], ignore_errors=True)
    t23 = time.perf_counter() - t
    print(f"phase 16 {t16:.1f} s, 22 {t22:.1f} s ({remote['transport']}), "
          f"21 (a)-(f) {t21:.1f} s, 23 {t23:.1f} s; parts of 23 "
          f"{fleet['phase_s']}", flush=True)
    print(f"launches: phase 22 "
          f"{ {k: v for k, v in remote['launches'].items() if v} }; "
          f"phase 23 {fleet['launches']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
