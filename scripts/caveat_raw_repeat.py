#!/usr/bin/env python3
"""Phase 10 of chip_smoke.py run several times in one process on one
CUDA card, to read the spread of its read-after-write ratio:

    python3 scripts/caveat_raw_repeat.py [--runs 5] [--out FILE]

Each run is `chip_smoke.caveats`: the caveated RBAC deployment
(`caveated_rbac(n_pods=200_000, n_users=50_000, n_groups=2_000)`) on a
fresh `torch://` endpoint, its kernels against their twins, the oracle,
and 8 rounds of caveat churn.  A round's read-after-write lookup batch
applies and flushes the round's writes and recaptures the sweep graph
first; the same batch is then run again with no write between, so a
round splits into the batch's own cost (`again_s`) and what the writes
added (`lookup_s - again_s`, of which `lookup_capture_ms` is the graph
capture).  The ratio is the rounds' median `lookup_s` over the run's
warm lookup median, as the smoke prints it (limit 1.10).  Prints the
card's nvidia-smi line first and one JSON object last (and to --out).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 1.10


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("caveat_raw_repeat: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(smi)
    peak = cs.hbm_peak(torch.cuda.get_device_name(0))
    timer = cs.Timer(torch, torch.device("cuda"))
    raw: list = []
    for i in range(args.runs):
        cs.log(f"-- run {i}")
        _, ep, _, write_path = cs.caveats(timer, peak, smi)
        raw.append(write_path)
        del ep
        gc.collect()
        torch.cuda.empty_cache()
    med = lambda rs, k: statistics.median(x[k] for x in rs)
    runs = []
    for r in raw:
        rs, warm = r["rounds"], r["warm_lookup_s"]
        runs.append({
            "warm_lookup_s": warm,
            "raw_lookup_s": med(rs, "lookup_s"),
            "ratio": med(rs, "lookup_s") / warm,
            "again_s": med(rs, "again_s"),
            "again_ratio": med(rs, "again_s") / warm,
            "writes_added_s": statistics.median(
                x["lookup_s"] - x["again_s"] for x in rs),
            "lookup_capture_ms": med(rs, "lookup_capture_ms"),
            "apply_ms": med(rs, "apply_ms"), "flush_ms": med(rs, "flush_ms"),
            "rounds": rs})
    over = sum(r["ratio"] > LIMIT for r in runs)
    cs.log(f"read-after-write over {LIMIT}x in {over} of {len(runs)} runs: "
           + ", ".join(f"{r['ratio']:.3f}x (again {r['again_ratio']:.3f}x, "
                       f"writes {r['writes_added_s'] * 1e3:.1f} ms)"
                       for r in runs))
    result = {"smi": smi, "limit": LIMIT, "over": over, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
