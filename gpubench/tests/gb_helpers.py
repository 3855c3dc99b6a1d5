"""Shared pieces of the benchmark's CPU tests: the tiny cells of
``data/`` (large-v3's vocabulary and token layout, 2 + 2 layers of width
64, float32), run through the whole harness on the CPU.

``data/bench.json`` holds only the tiny configurations and cells; their
metrics are the repo's own (``BENCHMARK.json``), each reported in a tiny
cell where it is reported in a real cell of the same driver, so a metric a
later change adds is read in the tiny runs with no edit here."""

import json
import pathlib
import time

from gpubench.lib import cell as cell_mod, spec

DATA = pathlib.Path(__file__).resolve().parent / "data"
SEED = 2**31 + 977  # past 32 signed bits, as seeds may be


def _driver(base: pathlib.Path, bench: dict, cell: str) -> str:
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    return json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())["driver"]


def tiny_bench() -> dict:
    """``BENCHMARK.json`` with the tiny configurations and cells in place of
    its own, each metric's ``workloads`` mapped by driver."""
    real, tiny = spec.load_benchmark(), json.loads((DATA / "bench.json").read_text())
    drivers = {w["name"]: _driver(DATA, tiny, w["name"]) for w in tiny["workloads"]}
    bench = {**real, **tiny}
    for group in ("end_to_end", "per_layer"):
        bench[group] = [dict(m) for m in real[group]]
        for m in bench[group]:
            if "workloads" in m:
                used = {_driver(spec.HERE, real, w) for w in m["workloads"]}
                m["workloads"] = [n for n, d in drivers.items() if d in used]
    return bench


def tiny(name: str) -> spec.Cell:
    return spec.cell(name, tiny_bench(), DATA)


def run_tiny(name: str, seconds: float = 1.0, trace: bool = False, seed: int = SEED) -> dict:
    return cell_mod.run_cell(tiny(name), seed, seconds, trace, "cpu", time.perf_counter())
