"""Package contract of the PyTorch port: it imports neither JAX nor the JAX
package; its entry points never drop to the CPU unasked; its kernel
wrappers launch or raise on anything but a CPU tensor; every CUDA source
is built; chip_smoke.py refuses to run without a GPU, and its bf16
tolerances fail kernels with the faults planted here."""

import ast
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "whisper_rs_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "whisper_rs_tpu"}


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_study.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_the_port_reads_its_own_vocabulary():
    """The tokenizer's default file is the port's package data, a copy of
    the JAX package's, so the installed command line needs nothing of the
    JAX package's directory."""
    from whisper_rs_tpu_torch.tokenize import tokenizer

    path = tokenizer._VENDORED_JSON
    assert path == PORT / "assets" / "gpt2.json"
    assert path.read_bytes() == (ROOT / "whisper_rs_tpu" / "assets" / "gpt2.json").read_bytes()
    for source in _sources():  # no path into the JAX package's directory
        assert "\"whisper_rs_tpu\" /" not in source.read_text(), source


def test_every_cuda_source_is_built():
    from whisper_rs_tpu_torch.ops import build

    assert sorted(build.SOURCES) == sorted(p.stem for p in build.CSRC.glob("*.cu"))
    paths = {build.library_path(n) for n in build.SOURCES}
    assert len(paths) == len(build.SOURCES)
    assert all(p.parent == build.BUILD_DIR for p in paths)


def test_one_build_and_load_of_a_library_under_threads(tmp_path, monkeypatch):
    """Two threads that ask for one library at once run one compile and load
    it once: ``_nvcc`` is a stub that writes its ``-o`` file slowly and
    counts its runs, ``ctypes.CDLL`` a stand-in that checks the file."""
    import threading
    import types

    from whisper_rs_tpu_torch.ops import build

    runs = tmp_path / "runs"
    stub = tmp_path / "nvcc"
    stub.write_text(f"""#!{sys.executable}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({str(runs)!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(0.5)
with open(out, "w") as f:
    f.write("library")
""")
    stub.chmod(0o755)
    loaded = []

    def fake_cdll(path):
        assert pathlib.Path(path).read_text() == "library"
        loaded.append(path)
        return types.SimpleNamespace(kernel_error_string=types.SimpleNamespace())

    monkeypatch.setattr(build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    start = threading.Barrier(2)
    got = []

    def ask():
        start.wait(timeout=30)
        got.append(build._library("mel"))

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and len(got) == 2
    assert got[0] is got[1]
    assert len(runs.read_text().splitlines()) == 1 and loaded == [str(build.library_path("mel"))]
    assert build.library_path("mel").exists()
    assert not list((tmp_path / "build").glob("*.tmp"))  # named by process and thread


def test_launch_counts_lose_nothing_under_threads():
    """count_launch is a locked read-modify-write: 16 threads adding to one
    key with the interpreter switching threads every microsecond lose no
    count."""
    import threading

    from whisper_rs_tpu_torch.ops import LAUNCHES, count_launch

    before = dict(LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch("log_mel")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert LAUNCHES["log_mel"] - before["log_mel"] == 32000
    assert {k: v for k, v in LAUNCHES.items() if k != "log_mel"} == {
        k: v for k, v in before.items() if k != "log_mel"}
    LAUNCHES["log_mel"] = before["log_mel"]


DIMS_KW = dict(
    n_mels=80, n_vocab=100, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=1, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=1,
)


def _entry_points():
    from whisper_rs_tpu_torch import cli
    from whisper_rs_tpu_torch.config import ModelDims
    from whisper_rs_tpu_torch.device import resolve_device
    from whisper_rs_tpu_torch.models import (
        init_random,
        load_checkpoint,
        load_hf_checkpoint,
        load_openai_checkpoint,
        load_params,
        params_from_state_dict,
    )
    from whisper_rs_tpu_torch.ops.mel import log_mel_frontend
    from whisper_rs_tpu_torch.serve import ServingEngine
    from whisper_rs_tpu_torch.tokenize import Tokenizer
    from whisper_rs_tpu_torch.tools import eval_wer, validate_checkpoint

    dims = ModelDims(**DIMS_KW)
    missing = ROOT / "no-such-checkpoint"  # the device is resolved before any read
    return {
        "resolve_device": lambda: resolve_device(),
        "log_mel_frontend": lambda: log_mel_frontend(np.zeros(480_000, np.float32)),
        "init_random": lambda: init_random(dims, 0),
        "params_from_state_dict": lambda: params_from_state_dict({}, dims),
        "load_openai_checkpoint": lambda: load_openai_checkpoint(missing),
        "load_hf_checkpoint": lambda: load_hf_checkpoint(missing),
        "load_params": lambda: load_params(missing),
        "load_checkpoint": lambda: load_checkpoint(missing),
        "cli": lambda: cli.main([str(missing), "--checkpoint", str(missing)]),
        "ServingEngine": lambda: ServingEngine(init_random(dims, 0), Tokenizer()),
        "eval_wer": lambda: eval_wer.main(["--checkpoint", str(missing),
                                           "--librispeech", str(missing)]),
        "validate_checkpoint": lambda: validate_checkpoint.main([
            "--checkpoint", str(missing), "--librispeech", str(missing)]),
    }


@pytest.mark.parametrize(
    "name",
    [
        "resolve_device", "log_mel_frontend", "init_random", "params_from_state_dict",
        "load_openai_checkpoint", "load_hf_checkpoint", "load_params", "load_checkpoint",
        "cli", "ServingEngine", "eval_wer", "validate_checkpoint",
    ],
)
def test_entry_points_without_device_raise_when_cuda_is_absent(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def _meta_calls():
    from whisper_rs_tpu_torch.ops.decode_attention import (
        beam_self_attention_step,
        cross_attention_step,
        self_attention_append_step,
        self_attention_fused_step,
        self_attention_step,
    )
    from whisper_rs_tpu_torch.ops.decoder_layer_fused import DecoderStepWeights, decoder_step_fused
    from whisper_rs_tpu_torch.ops.decoder_mlp_fused import decoder_mlp_step
    from whisper_rs_tpu_torch.ops.encoder_attention import (
        encoder_attention_merged,
        encoder_attention_split,
    )
    from whisper_rs_tpu_torch.ops.encoder_fused import ln_fused, residual_ln
    from whisper_rs_tpu_torch.ops.mel import raw_log10_mel
    from whisper_rs_tpu_torch.models.whisper import int8_mm

    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    return {
        "int8_mm": lambda: int8_mm(torch.empty(5, 64, dtype=torch.int8, device="meta"),
                                   torch.empty(32, 64, dtype=torch.int8, device="meta")),
        "encoder_attention_split": lambda: encoder_attention_split(
            m(1, 3, 8, 16), m(1, 3, 8, 16), m(1, 3, 8, 16), 0.25
        ),
        "raw_log10_mel": lambda: raw_log10_mel(m(1, 480_400), 80),
        "ln_fused": lambda: ln_fused(m(2, 64), m(64), m(64)),
        "residual_ln": lambda: residual_ln(m(2, 64), m(2, 64), m(64), m(64)),
        "encoder_attention_merged": lambda: encoder_attention_merged(
            m(1, 8, 128), m(1, 8, 128), m(1, 8, 128), 2, 0.125
        ),
        "cross_attention_step": lambda: cross_attention_step(m(1, 1, 2, 64), m(1, 1, 2, 2, 64, 8), 0),
        "cross_attention_step_g10": lambda: cross_attention_step(
            m(1, 10, 2, 64), m(1, 1, 2, 2, 64, 8), 0
        ),
        "self_attention_append_step": lambda: self_attention_append_step(
            m(1, 2, 64), m(1, 2, 64), m(1, 2, 64), m(1, 1, 2, 16, 64), m(1, 1, 2, 16, 64), 0, 3,
            window=8,
        ),
        "beam_self_attention_step": lambda: beam_self_attention_step(
            m(2, 2, 64), m(2, 2, 64), m(2, 2, 64), m(1, 2, 2, 16, 64), m(1, 2, 2, 16, 64), 0, 3,
            None, torch.empty(2, 16, dtype=torch.int32, device="meta"), 2, window=8,
        ),
        "decoder_mlp_step": lambda: decoder_mlp_step(m(2, 128), m(512, 128), m(512), m(128, 512)),
        "self_attention_fused_step": lambda: self_attention_fused_step(
            m(1, 2, 64), m(1, 1, 2, 16, 64), m(1, 1, 2, 16, 64), 0, 3, window=8,
        ),
        "decoder_step_fused": lambda: decoder_step_fused(
            m(2, 128), DecoderStepWeights((), m(1, 21)), m(1, 2, 2, 2, 64, 8),
            m(1, 2, 2, 16, 64), m(1, 2, 2, 16, 64), 3, None, n_head=2, group=1, window=8,
        ),
        "self_attention_step": lambda: self_attention_step(
            m(1, 2, 64), m(1, 1, 2, 16, 64), m(1, 1, 2, 16, 64), 0, 3, window=8,
        ),
    }


@pytest.mark.parametrize(
    "name",
    [
        "raw_log10_mel", "ln_fused", "residual_ln", "encoder_attention_merged",
        "cross_attention_step", "self_attention_append_step", "beam_self_attention_step",
        "decoder_mlp_step", "self_attention_fused_step", "decoder_step_fused",
        "self_attention_step", "encoder_attention_split", "cross_attention_step_g10",
        "int8_mm",
    ],
)
def test_wrappers_raise_off_the_cpu_without_a_kernel(name):
    """No wrapper takes its plain version for a tensor that is not on the
    CPU: a device it cannot launch on is an error, not a fallback."""
    from whisper_rs_tpu_torch.ops import LAUNCHES

    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device"):
        _meta_calls()[name]()
    assert LAUNCHES == before


def _refused_calls():
    """Each wrapper on meta tensors of a shape its predicate refuses: head
    dim 24 (the step, cross and split kernels are built for 16 and 64), D
    60 for the MLP (not a multiple of 8), rows of 60,000 for the LayerNorm
    pair (an f32 row past a block's shared memory)."""
    from whisper_rs_tpu_torch.ops.decode_attention import (
        beam_self_attention_step,
        cross_attention_step,
        self_attention_append_step,
        self_attention_fused_step,
        self_attention_step,
    )
    from whisper_rs_tpu_torch.ops.decoder_mlp_fused import decoder_mlp_step
    from whisper_rs_tpu_torch.ops.encoder_attention import encoder_attention_split

    from whisper_rs_tpu_torch.ops.encoder_fused import ln_fused, residual_ln

    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    wide = 60_000  # an f32 row past a block's shared memory
    return {
        "ln_fused": lambda: ln_fused(m(2, wide), m(wide), m(wide)),
        "residual_ln": lambda: residual_ln(m(2, wide), m(2, wide), m(wide), m(wide)),
        "encoder_attention_split": lambda: encoder_attention_split(
            m(1, 3, 8, 24), m(1, 3, 8, 24), m(1, 3, 8, 24), 0.2
        ),
        "cross_attention_step": lambda: cross_attention_step(
            m(1, 5, 4, 24), m(1, 1, 4, 2, 24, 8), 0
        ),
        "self_attention_append_step": lambda: self_attention_append_step(
            m(1, 4, 24), m(1, 4, 24), m(1, 4, 24), m(1, 1, 4, 16, 24), m(1, 1, 4, 16, 24), 0, 3,
            window=8,
        ),
        "beam_self_attention_step": lambda: beam_self_attention_step(
            m(2, 4, 24), m(2, 4, 24), m(2, 4, 24), m(1, 2, 4, 16, 24), m(1, 2, 4, 16, 24), 0, 3,
            None, torch.empty(2, 16, dtype=torch.int32, device="meta"), 2, window=8,
        ),
        "decoder_mlp_step": lambda: decoder_mlp_step(m(2, 60), m(240, 60), m(240), m(60, 240)),
        "self_attention_fused_step": lambda: self_attention_fused_step(
            m(1, 4, 24), m(1, 1, 4, 16, 24), m(1, 1, 4, 16, 24), 0, 3, window=8,
        ),
        "self_attention_step": lambda: self_attention_step(
            m(1, 4, 24), m(1, 1, 4, 16, 24), m(1, 1, 4, 16, 24), 0, 3, window=8,
        ),
    }


@pytest.mark.parametrize("name", [
    "beam_self_attention_step", "cross_attention_step", "decoder_mlp_step",
    "encoder_attention_split", "self_attention_append_step", "self_attention_fused_step",
    "self_attention_step", "ln_fused", "residual_ln",
])
def test_refused_shapes_raise_off_the_cpu(name):
    """Off the CPU, a shape the wrapper's predicate refuses raises before any
    launch, naming the shape as the cause (on the meta device here, which
    would raise for the device otherwise); it never takes the plain
    version, and no count moves."""
    from whisper_rs_tpu_torch.ops import LAUNCHES

    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="does not take this shape"):
        _refused_calls()[name]()
    assert LAUNCHES == before


@pytest.mark.parametrize("case,takes", [
    ("step dh 64", True), ("step dh 16", True), ("step dh 24", False),
    ("cross dh 64 Tk 1500", True), ("cross dh 16 Tk 1500", True),
    ("cross dh 24 Tk 1500", False), ("cross dh 64 Tk 1502", False),
    ("mlp D 512", True), ("mlp D 1280", True), ("mlp D 576", True), ("mlp D 64", True),
    ("mlp D 60", False),
    ("split dh 16", True), ("split dh 64", True), ("split dh 128", False),
    ("split dh 24", False), ("mlp D 512 hidden 1024", True), ("mlp D 1280 hidden 1280", True),
    ("mlp D 512 hidden 1020", False),
    ("merged H 8 dh 64", True), ("merged H 5 dh 64", False), ("merged H 4 dh 16", False),
    ("layer 16 rows", True), ("layer 17 rows", False), ("layer G 8", True),
    ("layer G 5", False), ("layer dh 16", False), ("layer Tk 1502", False),
    ("layer shared memory", False),
    ("ln D 64", True), ("ln D 1280", True), ("ln D 4097", True), ("ln D 58048", True),
    ("ln D 58049", False), ("ln D 0", False),
])
def test_route_predicates(case, takes):
    """Each wrapper's predicate at the limits of its kernel: head dim 16 or
    64 for the step kernels and the cross kernel (which takes any G, so G is
    no argument), D % 8 for the MLP, the split kernel's two head dims, the
    JAX encoder's merged route, and the whole-step kernel's rows, groups,
    head dim, Tk and shared memory (f32 at D 1024: 16 rows stage 256 KiB)."""
    from whisper_rs_tpu_torch.ops.decode_attention import cross_kernel_takes, step_kernel_takes
    from whisper_rs_tpu_torch.ops.decoder_layer_fused import layer_kernel_takes
    from whisper_rs_tpu_torch.ops.decoder_mlp_fused import mlp_kernel_takes
    from whisper_rs_tpu_torch.ops.encoder_attention import merged_kernel_takes, split_kernel_takes
    from whisper_rs_tpu_torch.ops.encoder_fused import ln_kernel_takes

    layer = dict(rows=8, group=1, head_dim=64, Tk=1500, n_ctx=448, d_model=1024, itemsize=2)
    calls = {
        "step dh 64": lambda: step_kernel_takes(64),
        "step dh 16": lambda: step_kernel_takes(16),
        "step dh 24": lambda: step_kernel_takes(24),
        "cross dh 64 Tk 1500": lambda: cross_kernel_takes(64, 1500),
        "cross dh 16 Tk 1500": lambda: cross_kernel_takes(16, 1500),
        "cross dh 24 Tk 1500": lambda: cross_kernel_takes(24, 1500),
        "cross dh 64 Tk 1502": lambda: cross_kernel_takes(64, 1502),
        "mlp D 512": lambda: mlp_kernel_takes(512),
        "mlp D 1280": lambda: mlp_kernel_takes(1280),
        "mlp D 576": lambda: mlp_kernel_takes(576),
        "mlp D 64": lambda: mlp_kernel_takes(64),
        "mlp D 60": lambda: mlp_kernel_takes(60),
        "mlp D 512 hidden 1024": lambda: mlp_kernel_takes(512, 1024),  # base.en at TP 2
        "mlp D 1280 hidden 1280": lambda: mlp_kernel_takes(1280, 1280),  # large-v3 at TP 4
        "mlp D 512 hidden 1020": lambda: mlp_kernel_takes(512, 1020),
        "split dh 16": lambda: split_kernel_takes(16),
        "split dh 64": lambda: split_kernel_takes(64),
        "split dh 128": lambda: split_kernel_takes(128),
        "split dh 24": lambda: split_kernel_takes(24),
        "merged H 8 dh 64": lambda: merged_kernel_takes(8, 64),
        "merged H 5 dh 64": lambda: merged_kernel_takes(5, 64),
        "merged H 4 dh 16": lambda: merged_kernel_takes(4, 16),
        "layer 16 rows": lambda: layer_kernel_takes(**dict(layer, rows=16)),
        "layer 17 rows": lambda: layer_kernel_takes(**dict(layer, rows=17)),
        "layer G 8": lambda: layer_kernel_takes(**dict(layer, rows=16, group=8)),
        "layer G 5": lambda: layer_kernel_takes(**dict(layer, rows=10, group=5)),
        "layer dh 16": lambda: layer_kernel_takes(**dict(layer, head_dim=16)),
        "layer Tk 1502": lambda: layer_kernel_takes(**dict(layer, Tk=1502)),
        "layer shared memory": lambda: layer_kernel_takes(**dict(layer, rows=16, itemsize=4)),
        "ln D 64": lambda: ln_kernel_takes(64),
        "ln D 1280": lambda: ln_kernel_takes(1280),
        "ln D 4097": lambda: ln_kernel_takes(4097),
        "ln D 58048": lambda: ln_kernel_takes(58048),  # (D + 64) f32 = 232,448 bytes
        "ln D 58049": lambda: ln_kernel_takes(58049),
        "ln D 0": lambda: ln_kernel_takes(0),
    }
    assert calls[case]() is takes


def _layer_takes_before(rows, group, head_dim, Tk, n_ctx, d_model, itemsize):
    """The whole-step kernel's predicate before its bf16 redesign: the
    largest of the staged rows [B, 4D], the cross scores and the self
    scores within 220 KiB."""
    smem = max(rows * 4 * d_model * itemsize, group * Tk * 4, n_ctx * 4)
    return (head_dim == 64 and rows <= 16 and group in (1, 2, 4, 8) and Tk % 4 == 0
            and smem <= 220 * 1024)


def test_layer_kernel_takes_every_registry_shape_it_took_before():
    """Every registry model's step of 1-16 rows in groups of 1, 2, 4 or 8,
    f32 or bf16, at n_audio_ctx keys and n_text_ctx slots, that the
    predicate took before the bf16 redesign, it takes now: no step that
    ran in one launch falls back to the append route."""
    from whisper_rs_tpu_torch.config import MODEL_REGISTRY
    from whisper_rs_tpu_torch.ops.decoder_layer_fused import layer_kernel_takes

    taken = 0
    for dims in MODEL_REGISTRY.values():
        for rows in range(1, 17):
            for group in (g for g in (1, 2, 4, 8) if rows % g == 0):
                for itemsize in (2, 4):
                    shape = (rows, group, dims.head_dim, dims.n_audio_ctx, dims.n_text_ctx,
                             dims.n_text_state, itemsize)
                    if _layer_takes_before(*shape):
                        taken += 1
                        assert layer_kernel_takes(*shape), shape
    assert taken > 500


def test_layer_route_takes_the_append_route_where_the_kernel_refuses(monkeypatch):
    """A layer-route step at the golden dims (head dim 16, D 64) off the
    CPU: counted once under "decoder_step_fused:append", then every layer
    calls the append route's kernel wrappers (the append self-attention,
    the cross attention and the MLP, each once a layer, and the LayerNorm
    three times a layer and once after them) and the whole-step kernel's
    never.  On the meta device, which computes shapes only, with
    each wrapper replaced by a recorder that runs its plain version."""
    import whisper_rs_tpu_torch.models.whisper as whisper
    from whisper_rs_tpu_torch.config import ModelDims
    from whisper_rs_tpu_torch.models import CrossKV, KVCache, TextDecoder
    from whisper_rs_tpu_torch.ops import LAUNCHES

    calls = {}
    for name in ("self_attention_append_step", "cross_attention_step", "decoder_mlp_step",
                 "decoder_step_fused", "ln_fused"):
        def recorder(*args, _name=name, _plain=getattr(whisper, f"{name}_plain"), **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*args, **kw)
        monkeypatch.setattr(whisper, name, recorder)
    dims = ModelDims(**dict(DIMS_KW, n_text_layer=2))
    with torch.device("meta"):
        dec = TextDecoder(dims.n_vocab, dims.n_text_ctx, dims.n_text_state, dims.n_text_head, 2)
    cache = KVCache.init(dims, 3, torch.float32, "meta")
    cross = CrossKV(torch.empty(2, 3, 4, 2, 16, 1500, device="meta"))
    before = dict(LAUNCHES)
    logits = dec(torch.zeros(3, 1, dtype=torch.long, device="meta"), 5, cross, cache,
                 incremental=True, step_kernel="layer")
    assert logits.shape == (3, 1, dims.n_vocab)
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    assert moved == {"decoder_step_fused:append": 1}
    assert calls == {"self_attention_append_step": 2, "cross_attention_step": 2,
                     "decoder_mlp_step": 2, "ln_fused": 3 * 2 + 1}


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    return importlib.import_module("chip_smoke")


def test_chip_smoke_refuses_without_cuda(chip_smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def _faulty_attention(fault):
    """A bf16 encoder or cross attention at chip_smoke's unit-scale inputs
    (one window, T = 1500): the right output and one with a fault."""
    from whisper_rs_tpu_torch.ops.decode_attention import cross_attention_step_plain
    from whisper_rs_tpu_torch.ops.encoder_attention import encoder_attention_merged_plain

    gen = torch.Generator().manual_seed(1)
    T, D, H, dh = 1500, 512, 8, 64
    if fault.startswith("cross"):
        q = (torch.randn(1, 1, H, dh, generator=gen) * dh**-0.5).bfloat16()
        kv = torch.randn(1, 1, H, 2, dh, T, generator=gen).bfloat16()
        return "cross_attention_step", (
            cross_attention_step_plain(q, kv, 0),
            cross_attention_step_plain(q, kv[..., : T - 28].contiguous(), 0),
        )
    q, k, v = (torch.randn(1, T, D, generator=gen).bfloat16() for _ in range(3))
    right = encoder_attention_merged_plain(q, k, v, H, dh**-0.5)
    if fault == "encoder_drops_last_28_keys":
        return "encoder_attention_merged", (
            right, encoder_attention_merged_plain(q, k, v, H, dh**-0.5, n_valid=T - 28)
        )
    return "encoder_attention_merged", (
        right, encoder_attention_merged_plain(q, k, v, H, 1.01 * dh**-0.5)
    )


@pytest.mark.parametrize(
    "fault", ["encoder_drops_last_28_keys", "encoder_qk_scale_1pct_off", "cross_drops_last_28_keys"]
)
def test_chip_smoke_bf16_tolerance_rejects_faulty_attention(chip_smoke, fault):
    """The bf16 tolerance of chip_smoke's kernel checks is tight enough to
    fail an attention kernel that drops the ragged last key tile (28 of
    1500 keys) or weights Q.K 1% wrong."""
    name, (right, wrong) = _faulty_attention(fault)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare(name, (wrong,), (right,), chip_smoke.tolerance(name, torch.bfloat16))


def _faulty_step_kernel(fault):
    """A bf16 append attention or decode MLP at chip_smoke's unit-scale
    inputs: the right output and one with a fault."""
    from whisper_rs_tpu_torch.ops.decode_attention import self_attention_append_step_plain
    from whisper_rs_tpu_torch.ops.decoder_mlp_fused import decoder_mlp_step_plain

    gen = torch.Generator().manual_seed(2)
    if fault.startswith("mlp"):
        B, D = 4, 512
        h = torch.randn(B, D, generator=gen).bfloat16()
        w1 = (torch.randn(4 * D, D, generator=gen) * D**-0.5).bfloat16()
        b1 = (torch.randn(4 * D, generator=gen) * 0.1).bfloat16()
        w2 = (torch.randn(D, 4 * D, generator=gen) * (4 * D) ** -0.5).bfloat16()
        return "decoder_mlp_step", (
            decoder_mlp_step_plain(h, w1, b1, w2),
            decoder_mlp_step_plain(h, w1, torch.zeros_like(b1), w2),
        )
    B, H, n_ctx, dh, pos = 2, 8, 448, 64, 400
    q = (torch.randn(B, H, dh, generator=gen) * dh**-0.5).bfloat16()
    k_new, v_new = (torch.randn(B, H, dh, generator=gen).bfloat16() for _ in range(2))
    k_all, v_all = (torch.randn(1, B, H, n_ctx, dh, generator=gen).bfloat16() for _ in range(2))
    key_start = torch.tensor([37, 250])

    def run(kn, vn, ks):
        return self_attention_append_step_plain(
            q, kn, vn, k_all.clone(), v_all.clone(), 0, pos, ks, window=n_ctx
        )

    right = run(k_new, v_new, key_start)
    if fault == "append_ignores_key_start":
        return "self_attention_append_step", (right, run(k_new, v_new, None))
    # reads slot pos of the cache before this step's column is written
    stale = (k_all[0, :, :, pos], v_all[0, :, :, pos])
    return "self_attention_append_step", (right, run(*stale, key_start))


@pytest.mark.parametrize(
    "fault", ["append_ignores_key_start", "append_reads_stale_own_slot", "mlp_drops_fc1_bias"]
)
def test_chip_smoke_bf16_tolerance_rejects_faulty_step_kernels(chip_smoke, fault):
    """The bf16 tolerances of the two step kernels fail an append attention
    that ignores key_start or reads its own slot before writing it, and an
    MLP that drops the fc1 bias."""
    name, (right, wrong) = _faulty_step_kernel(fault)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare(name, (wrong,), (right,), chip_smoke.tolerance(name, torch.bfloat16))


def _faulty_beam_attention(fault):
    """A bf16 beam self-attention at chip_smoke's unit-scale inputs and its
    W = 448, pos = 400 check (A = 2 audios of G = 5 beams, random
    ancestors, key_start varied within each audio): the right output and one
    with a fault."""
    from whisper_rs_tpu_torch.ops.decode_attention import (
        beam_self_attention_step_plain,
        self_attention_append_step_plain,
    )

    gen = torch.Generator().manual_seed(3)
    A, G, H, n_ctx, dh, pos = 2, 5, 8, 448, 64, 400
    B = A * G
    q = (torch.randn(B, H, dh, generator=gen) * dh**-0.5).bfloat16()
    k_new, v_new = (torch.randn(B, H, dh, generator=gen).bfloat16() for _ in range(2))
    k_all, v_all = (torch.randn(1, B, H, n_ctx, dh, generator=gen).bfloat16() for _ in range(2))
    anc = torch.randint(0, G, (B, n_ctx), generator=gen, dtype=torch.int32)
    anc[:, pos] = torch.arange(B, dtype=torch.int32) % G
    key_start = torch.arange(B) * 37 % 231 + 1
    first = torch.arange(B) // G * G
    right = beam_self_attention_step_plain(
        q, k_new, v_new, k_all.clone(), v_all.clone(), 0, pos, key_start, anc, G, window=n_ctx
    )
    if fault == "beam_ignores_ancestors":  # reads the row's own cache
        return right, self_attention_append_step_plain(
            q, k_new, v_new, k_all.clone(), v_all.clone(), 0, pos, key_start[first], window=n_ctx
        )
    # resolves the ancestors but masks by the row's own key_start
    ids = torch.arange(n_ctx)
    src = first[:, None] + anc.long()
    own = [c[0][src, :, ids].transpose(1, 2)[None].contiguous() for c in (k_all, v_all)]
    return right, self_attention_append_step_plain(
        q, k_new, v_new, *own, 0, pos, key_start, window=n_ctx
    )


@pytest.mark.parametrize("fault", ["beam_ignores_ancestors", "beam_masks_by_own_key_start"])
def test_chip_smoke_bf16_tolerance_rejects_faulty_beam_attention(chip_smoke, fault):
    """The bf16 tolerance of the beam self-attention check fails a kernel
    that reads the row's own cache instead of its ancestors', and one that
    masks by the row's own key_start instead of its audio's first row's."""
    right, wrong = _faulty_beam_attention(fault)
    name = "beam_self_attention_step"
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare(name, (wrong,), (right,), chip_smoke.tolerance(name, torch.bfloat16))


def test_chip_smoke_selection_margin_is_the_gap_after_the_beam_th_unfinished(chip_smoke):
    """The beam parity excuses a candidate mismatch only where the plain
    path's selection margin fell below 1e-3: the gap between the beam-th
    unfinished candidate and the next.  A near tie elsewhere in the ranking
    (here an EOT and an unfinished candidate 2e-4 apart) does not count."""
    from types import SimpleNamespace

    V, beam, eot = 50, 2, 7
    raw = torch.full((beam, V), -30.0)
    raw[0, [eot, 3, 4]] = torch.tensor([-0.5, -0.5002, -1.5])
    raw[1, [5, 6, 8]] = torch.tensor([-1.0, -2.0, -2.5])
    lp = torch.log_softmax(raw, dim=-1)
    # ranked: 5 (beam 1), EOT, 3 (the second unfinished), 6, 4, 8
    margin = chip_smoke.selection_margins(lp, SimpleNamespace(sum_logprobs=torch.zeros(beam)),
                                          beam, eot)
    assert margin.shape == (1,)
    assert margin.item() == pytest.approx((lp[0, 3] - lp[1, 6]).item(), rel=1e-6)
    assert margin.item() > 0.5


def _layer_step_outputs(chip_smoke, fault=None):
    """Row 12 in bf16 at chip_smoke's first check: medium.en width (vocab
    cut, the step never reads the embedding), LAYER_BF16_DEPTH layers, 8
    rows, W 256, pos 255, key_start in 1..231; the plain step's outputs (x, K and V
    columns), with a fault planted or, for "reordered", every product summed
    in f64 as another order of f32 sums would round."""
    import dataclasses

    from whisper_rs_tpu_torch.config import dims_for
    from whisper_rs_tpu_torch.ops import decoder_layer_fused as dlf

    dims = dataclasses.replace(dims_for("medium.en"), n_vocab=64)
    depth, B, W, pos = chip_smoke.LAYER_BF16_DEPTH, 8, 256, 255
    gen = torch.Generator().manual_seed(3)
    dec = chip_smoke.random_decoder(dims, depth, torch.bfloat16, gen, "cpu")
    weights = dlf.decoder_step_weights(dec.blocks)
    x, kv, kc, vc = chip_smoke.layer_step_case(dims, depth, B, 1, torch.bfloat16, gen, "cpu")
    ks = torch.arange(B) * 37 % 231 + 1

    def run(weights=weights, ks=ks):
        return chip_smoke.layer_step(dlf.decoder_step_fused_plain, weights, x, kv,
                                     (kc.clone(), vc.clone()), pos, ks, dims.n_text_head, 1, W)

    right = run()
    if fault == "masks_from_key_start_plus_1":
        return right, run(ks=ks + 1)
    if fault in SPLIT_K_FAULTS:
        # the bf16 kernel's split-K merge with a fault, in every layer: each
        # K-slice's f32 partial of the product, summed in slice order with
        # one slice dropped or one added twice, then rounded
        which, drop, twice = SPLIT_K_FAULTS[fault]
        ph = dlf.layer_launch_plan(16, dims.n_text_state, 132, 2, dims.n_audio_ctx,
                                   dims.n_text_ctx).phases[dlf.PROJECTIONS.index(which)]
        assert ph.slices > 1
        col = dlf.WEIGHT_NAMES.index("mlp.2.weight")
        targets = {id(layer[col]) for layer in weights.layers}
        real_dot = dlf._dot

        def split_dot(a, w):
            if id(w) not in targets:
                return real_dot(a, w)
            parts = [a[:, s * ph.width:(s + 1) * ph.width].float()
                     @ w[:, s * ph.width:(s + 1) * ph.width].float().T for s in range(ph.slices)]
            total = torch.zeros_like(parts[0])
            for s, part in enumerate(parts):
                total = total + part * ((s != drop) + (s == twice))
            return total.to(a.dtype)

        dlf._dot = split_dot
        try:
            return right, run()
        finally:
            dlf._dot = real_dot
    if fault == "skips_layer_1_cross_attention":  # its out-projection and bias to 0
        layers = [list(layer) for layer in weights.layers]
        wco = dlf.WEIGHT_NAMES.index("cross_attn.out.weight")
        layers[1][wco] = torch.zeros_like(layers[1][wco])
        layers[1][wco + 1] = torch.zeros_like(layers[1][wco + 1])
        return right, run(dlf.DecoderStepWeights(tuple(map(tuple, layers)), weights.table))
    real_dot = dlf._dot
    dlf._dot = lambda a, w: (a.double() @ w.double().T).to(a.dtype)
    try:
        return right, run()
    finally:
        dlf._dot = real_dot


# faults of a split-K merge: (projection, slice dropped, slice added twice)
SPLIT_K_FAULTS = {
    "drops_one_fc2_k_slice": ("fc2", 1, None),
    "drops_the_owners_fc2_k_slice": ("fc2", 0, None),
    "adds_an_fc2_partial_twice": ("fc2", None, 1),
}


@pytest.mark.parametrize("fault", ["skips_layer_1_cross_attention", "masks_from_key_start_plus_1",
                                   *SPLIT_K_FAULTS])
def test_chip_smoke_bf16_tolerance_rejects_faulty_layer_step(chip_smoke, fault):
    """The whole-step kernel's bf16 tolerance at 4 layers fails a step that
    skips one layer's cross-attention or masks from key_start + 1, and a
    split-K merge of fc2 (the bf16 kernel's plan at 16 rows: two K-slices)
    that drops a slice's partial, either one, or adds one twice."""
    right, wrong = _layer_step_outputs(chip_smoke, fault)
    name = "decoder_step_fused"
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare(name, wrong, right, chip_smoke.tolerance(name, torch.bfloat16))


def test_chip_smoke_bf16_tolerance_takes_sums_in_another_order(chip_smoke):
    """...and takes a step whose products are summed in another order, as
    the kernel's are, with a margin: under 0.7 of the tolerance."""
    right, reordered = _layer_step_outputs(chip_smoke, "reordered")
    name = "decoder_step_fused"
    _, share = chip_smoke.compare(name, reordered, right, chip_smoke.tolerance(name, torch.bfloat16))
    assert 0 < share < 0.7


def _faulty_int8_attention(fault):
    """Row 10 or the beam kernel's int8 read in bf16 at chip_smoke's
    unit-scale inputs and its W 448, pos 400 check (caches quantised per
    position from unit-scale values, key_start in 1..231, for the beam A = 2
    audios of G = 5 with random ancestors): the right output and one with a
    fault: a kernel that ignores k_scale or v_scale, or a beam kernel that
    takes slot j's scales from row b instead of the ancestor's row."""
    from whisper_rs_tpu_torch.models import quantize_kv
    from whisper_rs_tpu_torch.ops.decode_attention import (
        beam_self_attention_step_plain,
        self_attention_step_plain,
    )

    gen = torch.Generator().manual_seed(4)
    A, G, H, n_ctx, dh, pos = 2, 5, 8, 448, 64, 400
    B = A * G if fault.startswith("beam") else 2
    q = (torch.randn(B, H, dh, generator=gen) * dh**-0.5).bfloat16()
    (k, ks), (v, vs) = (quantize_kv(torch.randn(1, B, H, n_ctx, dh, generator=gen))
                        for _ in range(2))
    key_start = torch.arange(B) * 37 % 231 + 1
    if not fault.startswith("beam"):
        def run(k_scale=ks, v_scale=vs):
            return self_attention_step_plain(q, k, v, 0, pos, key_start, window=n_ctx,
                                             k_scale=k_scale, v_scale=v_scale)

        ones = torch.ones_like(ks)
        return "self_attention_step", run(), run(**{fault.removeprefix("row10_ignores_"): ones})
    anc = torch.randint(0, G, (B, n_ctx), generator=gen, dtype=torch.int32)
    anc[:, pos] = torch.arange(B, dtype=torch.int32) % G
    right = beam_self_attention_step_plain(q, None, None, k, v, 0, pos, key_start, anc, G,
                                           window=n_ctx, k_scale=ks, v_scale=vs)
    # the ancestors' K/V rows with the scales of each row b itself
    first = torch.arange(B) // G * G
    src = first[:, None] + anc.long()
    ids = torch.arange(n_ctx)
    k_anc, v_anc = (c[0][src, :, ids].transpose(1, 2)[None].contiguous() for c in (k, v))
    wrong = self_attention_step_plain(q, k_anc, v_anc, 0, pos, key_start[first], window=n_ctx,
                                      k_scale=ks, v_scale=vs)
    return "beam_self_attention_step", right, wrong


@pytest.mark.parametrize(
    "fault", ["row10_ignores_k_scale", "row10_ignores_v_scale", "beam_reads_row_b_scales"]
)
def test_chip_smoke_bf16_tolerance_rejects_faulty_int8_attention(chip_smoke, fault):
    """The bf16 tolerance of the int8 step checks fails a row 10 kernel
    that ignores either scale, and a beam kernel that reads each slot's
    scales from the row itself instead of from its ancestor's row."""
    name, right, wrong = _faulty_int8_attention(fault)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare(name, (wrong,), (right,), chip_smoke.tolerance(name, torch.bfloat16))


@pytest.mark.parametrize("fault", ["drops_last_28_keys", "qk_scale_1pct_off", "ignores_n_valid"])
def test_chip_smoke_bf16_tolerance_rejects_faulty_split_attention(chip_smoke, fault):
    """Row 6's bf16 tolerance at chip_smoke's golden-dims shape (head dim
    16, unit-scale q, k, v) fails a split attention that drops the last 28
    keys, scales Q.K 1% wrong, or ignores n_valid."""
    from whisper_rs_tpu_torch.ops.encoder_attention import encoder_attention_split_plain as attn

    gen = torch.Generator().manual_seed(1)
    shape = chip_smoke.SPLIT_SHAPES[chip_smoke.GOLDEN_LABEL]
    T, dh = shape[2], shape[3]
    q, k, v = (torch.randn(*shape, generator=gen).bfloat16() for _ in range(3))
    nv = T - 37 if fault == "ignores_n_valid" else None
    right = attn(q, k, v, dh**-0.5, nv)
    wrong = {"drops_last_28_keys": lambda: attn(q, k, v, dh**-0.5, T - 28),
             "qk_scale_1pct_off": lambda: attn(q, k, v, 1.01 * dh**-0.5),
             "ignores_n_valid": lambda: attn(q, k, v, dh**-0.5)}[fault]()
    name = "encoder_attention_split"
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare(name, (wrong,), (right,), chip_smoke.tolerance(name, torch.bfloat16))


def _window(tokens, avg=-1.0):
    from whisper_rs_tpu_torch import DecodeOutput

    return DecodeOutput(tokens=np.asarray(tokens), text="", avg_logprob=avg, no_speech_prob=0.1)


@pytest.mark.parametrize("beam", [False, True])
def test_chip_smoke_compare_windows_stops_only_below_the_plain_margin(chip_smoke, beam):
    """The transcription parity: equal windows pass; a divergent window
    passes (and stops the comparison) only where the plain path's margin
    there is below 1e-3 (greedy: at the first divergent token; beam: the
    audio's smallest selection margin in that window); an avg_logprob off
    by more than 1e-3 fails."""
    plain = [([_window([1, 2, 3])], 3), ([_window([4, 5, 6])], 3)]
    kernel = [([_window([1, 2, 3])], 3), ([_window([4, 9, 6])], 3)]
    close = [[1.0, 1.0, 1.0], [1.0, 5e-4, 1.0]] if not beam else [torch.tensor([1.0]),
                                                                    torch.tensor([5e-4])]
    wide = [[1.0] * 3, [1.0, 2e-3, 1.0]] if not beam else [torch.tensor([1.0]),
                                                          torch.tensor([2e-3])]
    assert chip_smoke.compare_windows("x", plain, plain, wide, beam)
    assert not chip_smoke.compare_windows("x", kernel, plain, close, beam)
    with pytest.raises(AssertionError, match="margin"):
        chip_smoke.compare_windows("x", kernel, plain, wide, beam)
    off = [([_window([1, 2, 3], avg=-1.01)], 3), plain[1]]
    with pytest.raises(AssertionError, match="avg_logprob"):
        chip_smoke.compare_windows("x", off, plain, wide, beam)


def _call(temperature, rows, chosen, row_margins=None, margin=None, rank_gap=None):
    """One recorded decode call of chip_smoke.recorded_calls: one audio,
    its rows' candidates (prompt [7] then the sampled tokens) and the
    chosen row's output."""
    cand = torch.tensor([[[7, *r] for r in rows]])
    return {"temperature": temperature, "outputs": [_window(rows[chosen])], "steps": 3,
            "candidates": cand, "sample_begin": 1, "margin": margin, "rank_gap": rank_gap,
            "row_margins": None if row_margins is None else torch.tensor(row_margins)}


@pytest.mark.parametrize("case", ["equal", "row apart, small margin", "row apart, wide margin",
                                  "chosen apart", "rank swap", "rung differs", "beam"])
def test_chip_smoke_compare_calls_holds_each_sampled_row_to_its_margin(chip_smoke, case):
    """The recipe's parity, call by call: a sampled row may leave the plain
    path's only at a step where the plain row's margin is below 1e-3 (and
    comparing stops where the chosen tokens then differ); equal rows with
    other chosen tokens need a ranking gap below 1e-3; a beam call keeps
    the selection-margin rule; the rung must match."""
    margins = [[1.0, 1.0], [1.0, 5e-4], [1.0, 1.0]]  # [steps, rows]
    plain = [_call(None, [[1, 2, 3]], 0, margin=1.0),
             _call(0.2, [[4, 5, 6], [4, 5, 8]], 0, margins, rank_gap=1.0)]
    if case == "equal":
        assert chip_smoke.compare_calls("x", plain, plain)
    elif case == "row apart, small margin":  # row 1 apart at step 1 (margin 5e-4)
        kernel = [plain[0], _call(0.2, [[4, 5, 6], [4, 9, 8]], 0)]
        assert chip_smoke.compare_calls("x", kernel, plain)
        kernel = [plain[0], _call(0.2, [[4, 5, 6], [4, 9, 8]], 1)]  # and chosen: stops
        assert not chip_smoke.compare_calls("x", kernel, plain)
    elif case == "row apart, wide margin":  # row 0 apart at step 2 (margin 1.0)
        kernel = [plain[0], _call(0.2, [[4, 5, 9], [4, 5, 8]], 0)]
        with pytest.raises(AssertionError, match="margin"):
            chip_smoke.compare_calls("x", kernel, plain)
    elif case == "chosen apart":  # the same rows, another row chosen, wide ranking gap
        kernel = [plain[0], _call(0.2, [[4, 5, 6], [4, 5, 8]], 1)]
        with pytest.raises(AssertionError, match="margin"):
            chip_smoke.compare_calls("x", kernel, plain)
    elif case == "rank swap":  # the same, the best two ranking scores 1e-4 apart
        close = [plain[0], {**plain[1], "rank_gap": 1e-4}]
        kernel = [plain[0], _call(0.2, [[4, 5, 6], [4, 5, 8]], 1)]
        assert not chip_smoke.compare_calls("x", kernel, close)
    elif case == "rung differs":
        with pytest.raises(AssertionError, match="rung"):
            chip_smoke.compare_calls("x", [plain[0], {**plain[1], "temperature": 0.4}], plain)
    else:
        kernel = [_call(None, [[1, 9, 3]], 0), plain[1]]
        with pytest.raises(AssertionError, match="margin"):
            chip_smoke.compare_calls("x", kernel, plain)
        close = [{**plain[0], "margin": 5e-4}, plain[1]]
        assert not chip_smoke.compare_calls("x", kernel, close)


def test_chip_smoke_route_counts(chip_smoke):
    """check_route_counts fails a kernel of the path that never launched or
    launched another number of times than expected, a kernel off the path
    that did launch, and the layer route's fallback where none was
    expected."""
    from whisper_rs_tpu_torch.ops import LAUNCHES

    base = dict.fromkeys(LAUNCHES, 0)
    ok = dict(base, log_mel=1, encoder_attention_split=2, cross_attention_step=4)
    want = {"log_mel": 1, "encoder_attention_split": True, "cross_attention_step": 4}
    chip_smoke.check_route_counts("x", ok, want)
    for bad in (
        dict(ok, encoder_attention_split=0),
        dict(ok, cross_attention_step=3),
        dict(ok, encoder_attention_merged=2),
        dict(ok, **{"decoder_step_fused:append": 1}),
    ):
        with pytest.raises(AssertionError):
            chip_smoke.check_route_counts("x", bad, want)


@pytest.mark.parametrize("device_type,backend,want", [
    ("cuda", "gloo", "stage"), ("cuda", "nccl", "device"), ("cpu", "gloo", "host"),
    ("cpu", "nccl", None), ("meta", "gloo", None),
])
def test_collective_routes(device_type, backend, want):
    """Under gloo a card's tensor is staged through host memory (gloo has no
    CUDA all-to-all, all-gather or send/recv), a CPU tensor taken as it is;
    under NCCL a card's tensor stays on the card, and a CPU tensor is
    refused."""
    from whisper_rs_tpu_torch.parallel.collectives import route

    if want is None:
        with pytest.raises(ValueError):
            route(device_type, backend)
    else:
        assert route(device_type, backend) == want


def test_initialize_multihost_does_nothing_for_one_process(monkeypatch):
    import torch.distributed as dist

    from whisper_rs_tpu_torch.parallel.distributed import initialize_multihost
    from whisper_rs_tpu_torch.parallel.mesh import make_mesh

    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is False
    assert initialize_multihost("127.0.0.1:1", 1, 0) is False
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert (mesh.n_stage, mesh.n_data, mesh.n_model, mesh.model_group) == (1, 1, 1, None)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(n_model=2)


def test_initialize_multihost_refuses_nccl_beyond_the_cards(monkeypatch):
    import torch.distributed as dist

    from whisper_rs_tpu_torch.parallel.distributed import initialize_multihost

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match='backend="gloo"'):
        initialize_multihost("127.0.0.1:1", 2, 0, backend="nccl")
    assert not dist.is_initialized()


def test_ranks_keep_the_environment_they_started_with(monkeypatch):
    """``Ranks`` returns once every rank has started, so a setting the
    caller changes while the ranks run (a test's own single-process run
    switching WHISPER_INT8_MATMUL) never reaches a rank."""
    import torch_ranks

    from whisper_rs_tpu_torch.parallel.launch import Ranks

    name = "WHISPER_RANKS_ENV_PROBE"
    monkeypatch.setenv(name, "before")
    ranks = Ranks(torch_ranks.env_rank, 2, args=(name,))
    monkeypatch.setenv(name, "after")
    assert ranks.wait(120) == ["before", "before"]


def test_layer_route_refuses_a_tensor_parallel_model():
    """The whole-step kernel cannot sum a layer's partial products over the
    model group: a split decoder refuses the layer route, the append and
    ctx routes take it."""
    from whisper_rs_tpu_torch.config import ModelDims
    from whisper_rs_tpu_torch.models import init_random
    from whisper_rs_tpu_torch.parallel.mesh import Mesh

    model = init_random(ModelDims(80, 1000, 1500, 64, 4, 2, 448, 64, 4, 2), 0, device="cpu")
    model.decoder.tp = Mesh(n_model=2)
    with pytest.raises(ValueError, match="tensor-parallel"):
        model.decoder.check_route("layer")
    model.decoder.check_route("append")
    model.decoder.check_route("ctx")


def test_debug_helpers(tmp_path, monkeypatch, caplog):
    """``start_profiler``/``stop_profiler`` write a Chrome trace holding a
    ``profiler_trace`` span; ``tensor_dbg`` logs only under
    WHISPER_DEBUG_TENSORS=1."""
    import json
    import logging

    from whisper_rs_tpu_torch.utils import debug

    debug.start_profiler(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        debug.start_profiler(str(tmp_path))
    with debug.profiler_trace("whisper-span"):
        torch.ones(4).sum()
    path = debug.stop_profiler()
    assert path.parent == tmp_path
    assert any(e.get("name") == "whisper-span" for e in json.loads(path.read_text())["traceEvents"])
    with caplog.at_level(logging.INFO, logger="whisper_rs_tpu_torch"):
        debug.tensor_dbg("x", torch.ones(3))
        assert not caplog.records
        monkeypatch.setattr(debug, "_DEBUG_TENSORS", True)
        debug.tensor_dbg("x", torch.full((3,), -2.0))
    assert "x: shape=(3,) mean=-2.0 absmax=2.0" in caplog.text
