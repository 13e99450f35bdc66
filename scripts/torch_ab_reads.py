#!/usr/bin/env python3
"""A/B of the `torch://` read path between checkouts, on one CUDA card.

    python3 scripts/torch_ab_reads.py ROOT [ROOT ...]

For each ROOT, in the order given (name a checkout twice to interleave,
e.g. parent, change, change, parent), a fresh process imports that
checkout's `chip_smoke.py` and runs its phases 3-5: multitenant-1m loaded
into `create_endpoint("torch://")`, then 6 lookup batches of 256 subjects
and 6 check batches of 10,000 pairs (`drive`, the same seeded requests in
every checkout).  Each run prints one JSON line with the per-batch wall
times and the warm medians; the card's name and power limit come first.
Needs one card; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_RUN = r"""
import contextlib, io, json, statistics, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
timer = cs.Timer(torch, torch.device("cuda"))
with contextlib.redirect_stdout(io.StringIO()):
    ep, w = cs.load("cuda", {})
    summary = cs.drive(ep, w, timer)[-1]
out = {"root": sys.argv[1]}
for verb in ("lookup", "check"):
    e2e = summary[verb]["e2e_s"]
    out[verb] = {"e2e_s": e2e, "warm_median_s": statistics.median(e2e[1:]),
                 "sweeps": summary[verb]["sweeps"][-1]}
print(json.dumps(out))
"""


def main() -> int:
    roots = sys.argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("torch_ab_reads: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", _RUN,
                               os.path.abspath(root)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
