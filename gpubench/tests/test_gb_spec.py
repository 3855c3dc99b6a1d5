"""Everything a cell needs is found by name, and a later change adds a
cell, a configuration, a traffic mix or a per-layer metric by files and
entries alone (shown in a copy of the benchmark)."""

import json
import re
import shutil

import pytest

from gpubench.lib import cell as cell_mod, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(name):
    c = spec.cell(name)
    assert c.config["source"] == next(x["source"] for x in BENCH["configs"]
                                      if x["name"] == c.config_name)
    assert c.traffic["driver"] in ("batch", "serve")
    compared = [k for k in cell_mod.COMPARED if k in c.limits]
    assert {"block0_rel_err", "rms_avg_logprob_gap", "mean_gap_logit"} <= set(compared)
    assert all(c.limits[k] > 0 for k in compared)
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert any(e["name"] == m["moves"] for e in c.end_to_end)


def test_benchmark_file_keeps_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (spec.ROOT / c["file"]).exists() and c["file"].startswith("gpubench/")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", ()):
            assert w in {x["name"] for x in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_a_new_cell_config_mix_and_metric_come_as_files(tmp_path):
    base = tmp_path / "gpubench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((base / "configs" / "large-v3.json").read_text())
    cfg["decoder_layers"] = 2
    cfg["port_model"] = "distil-large-v3"
    (base / "configs" / "distil-large-v3.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "greedy-b32.json").read_text())
    mix["audios"] = 16
    (base / "traffic" / "greedy-b16.json").write_text(json.dumps(mix))
    (base / "limits" / "distil-large-v3.greedy-b16.json").write_text('{"max_gap_logit": 0.5}')
    (base / "metrics" / "calls.batch.py").write_text(
        "def read(run):\n    return float(len(run.calls)) if run.calls else None\n")
    bench["configs"].append({"name": "distil-large-v3", "source": "x", "reduced": [],
                             "file": "gpubench/configs/distil-large-v3.json", "why": "x"})
    bench["workloads"].append({"name": "distil-large-v3.greedy-b16", "config": "distil-large-v3",
                               "traffic": "greedy-b16", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls.batch", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "the whole window",
                               "moves": "audio_s_per_s",
                               "workloads": ["distil-large-v3.greedy-b16"]})
    bench["end_to_end"][0]["workloads"].append("distil-large-v3.greedy-b16")
    c = spec.cell("distil-large-v3.greedy-b16", bench, base)
    assert c.dims["n_text_layer"] == 2 and c.traffic["audios"] == 16
    assert c.limits == {"max_gap_logit": 0.5}
    assert [m["name"] for m in c.end_to_end] == ["audio_s_per_s", "setup_s"]
    assert "calls.batch" in [m["name"] for m in c.per_layer]
    reader = spec.metric_reader("calls.batch", base)

    class Run:
        calls = [1, 2, 3]

    assert reader(Run()) == 3.0
    # the cells already there are untouched by the addition
    assert "calls.batch" not in [m["name"] for m in spec.cell("large-v3.greedy-b32", bench,
                                                               base).per_layer]
