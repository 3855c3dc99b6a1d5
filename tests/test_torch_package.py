"""Package contract of the PyTorch port: it imports neither JAX nor the JAX
package; its entry points never drop to the CPU unasked; its kernel
wrappers launch or raise on anything but a CPU tensor; every CUDA source
is built; chip_smoke.py refuses to run without a GPU."""

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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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


def test_every_cuda_source_is_built():
    from whisper_rs_tpu_torch.ops import build

    assert sorted(build.SOURCES) == sorted(p.stem for p in build.CSRC.glob("*.cu"))
    paths = {build.library_path(n) for n in build.SOURCES}
    assert len(paths) == len(build.SOURCES)
    assert all(p.parent == build.BUILD_DIR for p in paths)


DIMS_KW = dict(
    n_mels=80, n_vocab=100, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=1, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=1,
)


def _entry_points():
    from whisper_rs_tpu_torch.config import ModelDims
    from whisper_rs_tpu_torch.device import resolve_device
    from whisper_rs_tpu_torch.models import init_random, params_from_state_dict
    from whisper_rs_tpu_torch.ops.mel import log_mel_frontend

    dims = ModelDims(**DIMS_KW)
    return {
        "resolve_device": lambda: resolve_device(),
        "log_mel_frontend": lambda: log_mel_frontend(np.zeros(480_000, np.float32)),
        "init_random": lambda: init_random(dims, 0),
        "params_from_state_dict": lambda: params_from_state_dict({}, dims),
    }


@pytest.mark.parametrize(
    "name", ["resolve_device", "log_mel_frontend", "init_random", "params_from_state_dict"]
)
def test_entry_points_without_device_raise_when_cuda_is_absent(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def _meta_calls():
    from whisper_rs_tpu_torch.ops.decode_attention import cross_attention_step
    from whisper_rs_tpu_torch.ops.encoder_attention import encoder_attention_merged
    from whisper_rs_tpu_torch.ops.encoder_fused import ln_fused, residual_ln
    from whisper_rs_tpu_torch.ops.mel import raw_log10_mel

    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    return {
        "raw_log10_mel": lambda: raw_log10_mel(m(1, 480_400), 80),
        "ln_fused": lambda: ln_fused(m(2, 64), m(64), m(64)),
        "residual_ln": lambda: residual_ln(m(2, 64), m(2, 64), m(64), m(64)),
        "encoder_attention_merged": lambda: encoder_attention_merged(
            m(1, 8, 128), m(1, 8, 128), m(1, 8, 128), 2, 0.125
        ),
        "cross_attention_step": lambda: cross_attention_step(m(1, 1, 2, 64), m(1, 1, 2, 2, 64, 8), 0),
    }


@pytest.mark.parametrize(
    "name",
    ["raw_log10_mel", "ln_fused", "residual_ln", "encoder_attention_merged", "cross_attention_step"],
)
def test_wrappers_raise_off_the_cpu_without_a_kernel(name):
    """No wrapper takes its plain version for a tensor that is not on the
    CPU: a device it cannot launch on is an error, not a fallback."""
    from whisper_rs_tpu_torch.ops import LAUNCHES

    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device"):
        _meta_calls()[name]()
    assert LAUNCHES == before


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
