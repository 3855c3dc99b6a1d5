"""Nothing the benchmark imports or runs is JAX or the JAX package: the
check compares each module's top-level name (the part before the first
dot) whole, since the port's name, ``whisper_rs_tpu_torch``, begins with
the JAX package's."""

import ast
import subprocess
import sys
import types

from gb_helpers import DATA
from gpubench.lib import cell as cell_mod, spec


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("whisper_rs_tpu_torch_x", "jaxfoo", "flaxen", "whisper_rs_tpu_torch.ops"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    clean = cell_mod.forbidden_modules()
    assert not any(m.startswith(("whisper_rs_tpu_torch", "jaxfoo", "flaxen")) for m in clean)
    for name in ("jax.numpy", "whisper_rs_tpu.ops", "flax", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert {"jax.numpy", "whisper_rs_tpu.ops", "flax", "jaxlib"} <= set(
        cell_mod.forbidden_modules())


def test_no_source_of_the_benchmark_imports_them():
    for path in spec.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in cell_mod.FORBIDDEN, (path, n)


def test_a_whole_run_loads_neither():
    code = (
        "import json, sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from gb_helpers import run_tiny\n"
        "from gpubench.lib import cell\n"
        "r = run_tiny('tiny.tiny-greedy', seconds=0.3)\n"
        "print(json.dumps({'correct': r['correct'], 'bad': cell.forbidden_modules(),"
        " 'port': 'whisper_rs_tpu_torch' in sys.modules}))\n"
    ) % (str(spec.ROOT), str(DATA.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout.strip().splitlines()[-1]
    assert out == '{"correct": true, "bad": [], "port": true}'


def test_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        return  # the refusal is for machines without one
    p = subprocess.run([sys.executable, str(spec.HERE / "run.py"), "--workload",
                        "large-v3.greedy-b32", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
