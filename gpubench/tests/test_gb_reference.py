"""The frozen float32 reference (``gpubench/reference/``) against the port's
plain path at tiny sizes on the CPU: the frontend, the encoder, a decoder
pass, the filters and the suppressed ids; then whole runs of the tiny
cells, whose f32 program must serve exactly the reference's tokens."""

import numpy as np
import pytest
import torch

from gb_helpers import SEED, run_tiny, tiny
from gpubench.lib import spec, weights
from gpubench.reference import tokens as ref_tokens, whisper_f32 as ref


@pytest.fixture(scope="module")
def model():
    from whisper_rs_tpu_torch.config import ModelDims
    from whisper_rs_tpu_torch.models.params import params_from_state_dict

    d = tiny("tiny.tiny-greedy").dims
    dims = ModelDims(d["n_mels"], d["n_vocab"], d["n_audio_ctx"], d["n_state"], d["n_head"],
                     d["n_audio_layer"], d["n_text_ctx"], d["n_state"], d["n_head"],
                     d["n_text_layer"])
    W = weights.draw(d, SEED, torch.float32, "cpu")
    return params_from_state_dict(W, dims, dtype=torch.float32, device="cpu"), W, d


def _audio(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_of_a_window(n_mels):
    from whisper_rs_tpu_torch.audio.mel import log_mel_spectrogram

    a = _audio(480_000) * 0.1
    torch.testing.assert_close(ref.log_mel(a, n_mels), log_mel_spectrogram(a, n_mels),
                               atol=2e-4, rtol=0)


def test_mel_of_a_short_clip_padded_to_a_window():
    from whisper_rs_tpu_torch.audio.mel import pad_or_trim
    from whisper_rs_tpu_torch.ops.mel import log_mel_file

    a = _audio(97_123, 1) * 0.1
    got = pad_or_trim(log_mel_file(a, 80, device="cpu"), 3000)
    torch.testing.assert_close(ref.window_mel(a, 80), got, atol=2e-4, rtol=0)


def test_encoder_and_a_decoder_pass(model):
    from whisper_rs_tpu_torch.models.whisper import KVCache, precompute_cross_kv

    m, W, d = model
    mel = ref.log_mel(_audio(480_000, 2) * 0.1, d["n_mels"])
    xa = m.encoder(mel[None], kernels=False)[0]
    want = ref.encoder(mel, W, d["n_head"], d["n_audio_layer"])
    torch.testing.assert_close(xa, want, atol=1e-4, rtol=1e-4)
    tokens = torch.tensor([50257, 50364, 1000, 2000, 50380, 300])
    cache = KVCache.init(m.dims, 1, torch.float32, "cpu")
    cross = precompute_cross_kv(m, want[None])
    got = m.decoder(tokens[None], 0, cross, cache, kernels=False)[0]
    torch.testing.assert_close(got, ref.decoder_logits(tokens, want, W, d["n_head"],
                                                       d["n_text_layer"]), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("timestamps", [True, False])
def test_filters_match_the_ports(timestamps):
    from whisper_rs_tpu_torch.decode.filters import FilterConfig, apply_filters

    t = tiny("tiny.tiny-greedy").config["tokens"]
    suppress = ref_tokens.non_speech_ids(str(spec.ROOT / "whisper_rs_tpu_torch/assets/gpt2.json"))
    cfg = FilterConfig(n_vocab=51866, token_id_eot=t["eot"], token_id_space=t["space"],
                       token_id_ts_begin=t["ts_begin"], token_id_no_timestamps=t["no_timestamps"],
                       timestamps=timestamps, suppress_ids=suppress,
                       max_initial_timestamp_index=50 if timestamps else None)
    g = torch.Generator().manual_seed(3)
    n, begin = 9, 4
    logits = torch.randn(n, 51866, generator=g) * 3
    logits[:, t["ts_begin"]:] += 4.0 * (torch.rand(n, 1, generator=g) > 0.5)  # both branches
    sampled = [50400, 500, 50410, 50420, 700, 50430, 800, 900, 50450]
    buf = torch.zeros(1, 448, dtype=torch.long)
    buf[0, begin:begin + n] = torch.tensor(sampled)
    want = torch.stack([apply_filters(cfg, logits[j:j + 1], buf, begin + j, begin)[0]
                        for j in range(n)])
    got = ref.filtered_logits(logits, sampled, t, suppress, timestamps, 50 if timestamps else None)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got[torch.isfinite(got)], want[torch.isfinite(want)])


def test_the_suppressed_ids_are_the_tokenizers():
    from whisper_rs_tpu_torch.config import MODEL_REGISTRY
    from whisper_rs_tpu_torch.tokenize import Tokenizer

    path = str(spec.ROOT / "whisper_rs_tpu_torch/assets/gpt2.json")
    assert ref_tokens.non_speech_ids(path) == tuple(
        Tokenizer.for_dims(MODEL_REGISTRY["large-v3"]).non_speech_tokens())


def test_token_gaps():
    f = torch.tensor([[3.0, 1.0, 2.0, float("-inf")]] * 3)
    assert ref.token_gaps(f, [0, 1, 3], 1).tolist() == [0.0, 2.0, float("inf")]
    assert ref.token_gaps(f, [2, 1, 0], 2).tolist() == [0.0, 1.0, 0.0]


@pytest.mark.parametrize("name", ["tiny.tiny-greedy", "tiny.tiny-beam", "tiny.tiny-serve"])
def test_a_float32_program_serves_the_references_tokens(name):
    r = run_tiny(name, seconds=2.0 if "serve" in name else 0.5)
    assert r["correct"], r["checked"]
    assert r["checked"]["rms_avg_logprob_gap"]["value"] < 1e-5
    assert r["checked"]["rms_no_speech_gap"]["value"] < 1e-4
    assert r["checked"]["tokens_compared"]["value"] >= 20
    assert list(r)[-1] == "checked"
