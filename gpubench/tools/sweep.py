"""The knee of a serving cell: the highest offered rate the engine
sustains with no growing backlog, found by a sweep of fixed rates in one
process (each rate a fresh engine on the same model).

    python3 gpubench/tools/sweep.py --workload <serving cell> --rates 60,80,100 \\
        [--seconds 20] [--seed 1]

Prints a JSON line a rate: requests offered and completed a second, the
median and 95th percentile latency, and the median latency of the last
quarter of requests over that of the first quarter (about 1 without a
backlog; growing with the queue above the knee).  The cell's traffic file
keeps the rate chosen from it.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from gpubench.lib import cell as cell_mod, spec

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    c = spec.cell(args.workload)
    program = cell_mod.Program(c, args.seed, torch.device("cuda"), False)
    for rate in (float(r) for r in args.rates.split(",")):
        c.traffic["rate_per_s"] = rate
        run = cell_mod.Run(c, args.seed, args.seconds, torch.device("cuda"))
        t0 = time.perf_counter()
        m = cell_mod.run_serve(run, program, False, t0)
        done = [r for r in run.requests if r.finished is not None]
        lat = [r.latency for r in run.requests]
        q = max(1, len(lat) // 4)
        span = max(r.finished for r in done) - min(r.due for r in run.requests) if done else 0
        print(json.dumps({
            "rate": rate, "offered": len(run.requests), "completed_per_s": len(done) / span,
            "p50_s": m["request_p50_s"], "p95_s": m["request_p95_s"], "failed": m["failed"],
            "growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
            "padded_share": 1 - run.engine_counts["windows_decoded"] / run.engine_counts["rows"],
            "late_p95_s": m["generator_late_p95_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
