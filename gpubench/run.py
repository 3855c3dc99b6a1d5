"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; everything it
needs is found by name under ``gpubench/`` (``lib/spec.py``).  The run
measures the PyTorch and CUDA port (``whisper_rs_tpu_torch``) on the card,
checks what its window served against the float32 reference, and prints as
the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; the numbers the check compared, each beside its limit, come
last, under ``checked``, and are also the last lines of standard error.

It exits with another code than 0, and prints no result, where CUDA is
absent or has fewer cards than the cell asks for, where the port is missing,
or where JAX or the JAX package was loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the run may write stays inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "gpubench" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from gpubench.lib import cell as cell_mod, spec

    c = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {c.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = cell_mod.run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = cell_mod.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print("set-up stages (s from the start): " + ", ".join(
        f"{k} {v:.2f}" for k, v in result.pop("stages").items()), file=sys.stderr)
    for name, v in result["checked"].items():
        print(f"checked {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
