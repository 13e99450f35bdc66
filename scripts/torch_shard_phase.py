"""Card run of chip_smoke.py's phase 21 alone.

    python3 scripts/torch_shard_phase.py      (one CUDA card)

Builds the kernels, makes multitenant-1m at its defaults and calls
`chip_smoke.shard_path` (the two-shard proxy on the card, (a)-(f)) and
`chip_smoke.shard_cli` (the shard leaders, the router and the lint as
processes, (g)), every check of the whole smoke's run of them included.
Prints the phase's log lines, its seconds and its launches by kernel;
exits non-zero on a failed check and without a card.
"""

import os
import subprocess
import sys
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_shard_phase: no CUDA device", file=sys.stderr)
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
    t = time.perf_counter()
    out = smoke.shard_path(w, smi)
    smoke.shard_cli(smi)
    print(f"phase 21 {time.perf_counter() - t:.1f} s; parts {out['phase_s']}; "
          f"launches {out['launches']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
