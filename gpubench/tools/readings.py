"""Readings of the correctness check for setting a cell's limit: the
program's numbers on many seeds, and its control's (the program's own
int8 path: ``quantize_params`` weights, the int8×int8 matmuls and int8
K/V), in one process (the
set-up is paid once for the kernels' build and the CUDA start).

    python3 gpubench/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds 4] [--trace-seeds 7] \\
        [--fault greedy-second-best|beam-keeps-the-worst]

Prints one JSON line a run: the seed, whether it was the control, the
compared numbers and the metrics.  With ``--fault`` every run of the
process decodes under that fault of ``lib/faults.py``.  Each seed builds its own model and
inputs, as a run of ``run.py`` does; nothing is compared with a limit.
"""

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--fault", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench.lib import cell as cell_mod, faults, spec

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    c = spec.cell(args.workload)
    todo = ([(int(s), False, False) for s in args.seeds.split(",") if s]
            + [(int(s), False, True) for s in args.trace_seeds.split(",") if s]
            + [(int(s), True, False) for s in args.control_seeds.split(",") if s])
    stack = contextlib.ExitStack()  # the fault, where given, for the whole process
    if args.fault:
        stack.enter_context(faults.FAULTS[args.fault]())
    for seed, control, trace in todo:
        t0 = time.perf_counter()
        r = cell_mod.run_cell(c, seed, args.seconds, trace, "cuda", t0, control=control,
                              limits={k: float("inf") for k in cell_mod.COMPARED})
        print(json.dumps({"seed": seed, "control": control, "trace": trace,
                          "fault": args.fault or None,
                          **{k: v["value"] for k, v in r["checked"].items()},
                          "stages": r.pop("stages"),
                          "failed": r["failed"], "attempted": r["attempted"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "device": r["device"], "breakdown": r.get("breakdown"),
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    stack.close()
    bad = cell_mod.forbidden_modules()
    print(json.dumps({"forbidden_modules": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
