"""Find everything a cell needs by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything else is found by name, so a later change adds a cell, a
configuration, a mix or a metric by adding files and entries alone:

  * ``configs/<config>.json``: the model's published sizes, as run;
  * ``traffic/<mix>.json``: the parameters of the mix, read by the one
    generator (``lib/gen.py``) and the driver the file names;
  * ``limits/<cell>.json``: the limit of each number the correctness check
    compares, with the readings it was set from;
  * ``metrics/<metric>.py``: the reader of one per-layer metric
    (``read(run) -> float or None``);
  * ``work/<name>.py``: the operations and bytes of one kernel call, or of
    a model's work, from shapes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import List, Optional

HERE = pathlib.Path(__file__).resolve().parents[1]  # gpubench/
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports

    @property
    def dims(self) -> dict:
        return dims_of(self.config)


def dims_of(config: dict) -> dict:
    """The sizes the weights and the reference take, from a config file's
    published keys."""
    if config["encoder_attention_heads"] != config["decoder_attention_heads"]:
        raise ValueError("encoder and decoder head counts differ")
    return {
        "n_mels": config["num_mel_bins"],
        "n_vocab": config["vocab_size"],
        "n_audio_ctx": config["max_source_positions"],
        "n_text_ctx": config["max_target_positions"],
        "n_state": config["d_model"],
        "n_head": config["encoder_attention_heads"],
        "n_audio_layer": config["encoder_layers"],
        "n_text_layer": config["decoder_layers"],
    }


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[dict] = None, base: pathlib.Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (default: the repo's BENCHMARK.json),
    its files read from ``base`` (default: this folder)."""
    bench = load_benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    limits_path = base / "limits" / f"{name}.json"
    return Cell(
        name=name,
        config_name=w["config"],
        traffic_name=w["traffic"],
        chips=w["chips"],
        config=_json(base / "configs" / f"{w['config']}.json"),
        traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=_json(limits_path) if limits_path.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def _load_file(path: pathlib.Path, label: str):
    if not path.exists():
        raise FileNotFoundError(f"{label}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"gpubench_{label}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, base: pathlib.Path = HERE):
    """The ``read`` function of per-layer metric ``name``."""
    return _load_file(base / "metrics" / f"{name}.py", "metric_" + name.replace(".", "_")).read


def work(name: str, base: pathlib.Path = HERE):
    """The module of ``work/<name>.py``."""
    return _load_file(base / "work" / f"{name}.py", "work_" + name)
