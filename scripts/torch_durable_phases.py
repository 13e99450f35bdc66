"""Card run of chip_smoke.py's phases 19 and 20 alone.

    python3 scripts/torch_durable_phases.py      (one CUDA card; ~100 s)

Builds the kernels, makes multitenant-1m at its defaults and phase 16's
fake kube-apiserver, and calls `chip_smoke.durable_path(...,
failover=True)`: the durable leader, its crash and recovery, a follower
tailing it and its re-bootstrap (phase 19), then the promotion, the
fenced ex-leader's rejoin, the relay's leaf and the election (phase 20),
every check of the whole smoke's run of them included.  Phase 19 (c),
the `python -m` process killed and restarted, is left out: it does not
touch the two nodes phase 20 runs on.  Prints each phase's log lines,
their seconds and phase 20's launches by kernel; exits non-zero on a
failed check and without a card.
"""

import os
import subprocess
import sys
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_durable_phases: no CUDA device", file=sys.stderr)
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
    t = time.perf_counter()
    kernels.build()
    kernels._load()
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    w = workloads.multitenant_1m()
    kube = smoke._seed_proxy_kube(smoke.PROXY_NAMESPACES, smoke.PROXY_PODS,
                                  smoke.PROXY_EVENTS)
    smoke.cli_crash = lambda *a, **k: None
    out = smoke.durable_path(w, kube, smi, failover=True)
    print(f"phase seconds {out['phase_s']}; phase 20 launches "
          f"{out['failover']['launches']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
