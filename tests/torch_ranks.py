"""Rank functions of the port's parallel tests (tests/test_torch_sharding.py,
test_torch_pipeline.py, test_torch_ulysses.py, test_torch_multihost.py,
test_torch_serve_parallel.py).

Each function runs in every rank process of one gloo group that
``whisper_rs_tpu_torch.parallel.launch.run_ranks`` spawns, on the CPU, and
returns numpy arrays and plain values, which the test holds against the
JAX package (run in the test process) and the port's single process.  This
module imports torch and the port only: a rank process never imports JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from whisper_rs_tpu_torch.config import (
    BeamSearchMode,
    DecodeOptions,
    GreedyMode,
    ModelDims,
    TranscribeOptions,
)
from whisper_rs_tpu_torch.decode import FilterConfig, decode_beam, decode_greedy
from whisper_rs_tpu_torch.models import params_from_state_dict, precompute_cross_kv
from whisper_rs_tpu_torch.models import quantize_params
from whisper_rs_tpu_torch.models.whisper import KVCache
from whisper_rs_tpu_torch.parallel import make_mesh, shard_model

CFG_KW = dict(token_id_eot=500, token_id_space=7, token_id_ts_begin=600,
              token_id_no_timestamps=599)
SOT, NO_SPEECH = 501, 502
GREEDY_LEN, BEAM_LEN = 6, 5
BEAM = BeamSearchMode(beam_size=2, patience=1.0)
SAMPLED = GreedyMode(temperature=0.7, group_size=2)
LOGIT_TOKENS = [[501, 601, 17, 23]]


class SmallTokenizer:
    """Duck-typed tokenizer with ids inside the tiny test vocab (the one of
    tests/test_torch_batch.py)."""

    token_id_sot = 501
    token_id_eot = 500
    token_id_no_speech = 502
    token_id_startofprev = 503
    token_id_startoflm = 504
    token_id_no_timestamps = 599
    token_id_ts_begin = 600
    token_id_space = 7

    def decode(self, toks):
        return "".join(f" w{int(t)}" for t in toks if int(t) < 500)

    def encode(self, text):
        return [9, 8]

    def sequence_sot(self):
        return [self.token_id_sot]

    def non_speech_tokens(self):
        return (3, 5)

    def decode_with_timestamps(self, toks):
        return self.decode(toks)


def transcribe_options(**kw) -> TranscribeOptions:
    """Greedy, 8 tokens a window, prompts conditioned on the previous text."""
    return TranscribeOptions(decode=DecodeOptions(mode=GreedyMode(), sample_len=8),
                             condition_on_prev_text=True, **kw)


def model_of(sd: dict, fields: dict, dtype=torch.float32):
    return params_from_state_dict(sd, ModelDims(**fields), dtype=dtype, device="cpu")


def filter_config(n_vocab: int) -> FilterConfig:
    return FilterConfig(n_vocab=n_vocab, **CFG_KW)


def forward_logits(model, mel: np.ndarray, tokens) -> np.ndarray:
    """The JAX ``model_forward``: encoder, cross K/V, one decoder pass over
    ``tokens`` [B, T] -> f32 logits [B, T, V]."""
    mel = torch.as_tensor(mel)
    xa = model.encoder(mel)
    tokens = torch.as_tensor(tokens, dtype=torch.long)
    cache = KVCache.init(model.dims, tokens.shape[0], xa.dtype, xa.device,
                         n_head=model.decoder.n_head)
    return model.decoder(tokens, 0, precompute_cross_kv(model, xa), cache).numpy()


def decodes(model, mel: np.ndarray, quantize_kv: bool = False, names=("greedy", "beam",
                                                                      "sampled")) -> dict:
    """Greedy, beam and sampled decodes (those of ``names``) of ``mel``
    prompted with the SOT alone: {name: (candidates, scores, no-speech
    probabilities)}."""
    cfg = filter_config(model.dims.n_vocab)
    initial = np.full((mel.shape[0], 1), SOT)
    mel = torch.as_tensor(mel)
    out = {}
    for name, fn, mode, n in (("greedy", decode_greedy, GreedyMode(), GREEDY_LEN),
                              ("beam", decode_beam, BEAM, BEAM_LEN),
                              ("sampled", decode_greedy, SAMPLED, GREEDY_LEN)):
        if name not in names:
            continue
        r = fn(model, mel, initial, 1, 0, cfg, mode, n, NO_SPEECH, quantize_kv=quantize_kv)
        out[name] = (r.candidates.numpy(), r.scores.numpy(), r.no_speech_probs.numpy())
    return out


def outputs_of(outs) -> list:
    """TranscribeOutputs -> (tokens, text, segments with their words)."""
    def seg(s):
        words = None if s.words is None else [(w.word, w.start, w.end) for w in s.words]
        return (s.seek, s.start_time, s.end_time, s.text, words)
    return [(np.asarray(o.tokens), o.text, [seg(s) for s in o.segments]) for o in outs]


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


# -- test_torch_sharding.py ----------------------------------------------------


def sharding_cases(sd, fields, sd_odd, fields_odd, mel, audios, mesh=None) -> dict:
    """The TP logits, the decodes (greedy, beam, sampled), int8 weights and
    K/V (with and without the int8×int8 matmuls), the batch driver, word
    timestamps, and a vocab that 2 does not divide: on ``mesh`` (each model
    cut by ``shard_model``), or in one process without one."""
    from whisper_rs_tpu_torch import TranscribeTask
    from whisper_rs_tpu_torch.parallel import BatchTranscriber

    def build(sd, fields, int8=False):
        model = model_of(sd, fields)
        if int8:
            quantize_params(model)
        return model if mesh is None else shard_model(model, mesh)

    model = build(sd, fields)
    tok = SmallTokenizer()
    out = {
        "bytes": param_bytes(model),
        "emb_rows": model.decoder.token_embedding.weight.shape[0],
        "n_head": (model.encoder.blocks[0].attn.n_head, model.decoder.n_head),
        "logits": forward_logits(model, mel, LOGIT_TOKENS * mel.shape[0]),
        "decodes": decodes(model, mel),
        "batch": outputs_of(BatchTranscriber(model, tok, transcribe_options(),
                                             batch_size=2).run(audios)),
        "words": outputs_of([TranscribeTask(model, tok, transcribe_options(
            word_timestamps=True)).run(audios[0])]),
    }
    odd = build(sd_odd, fields_odd)
    out["odd_rows"] = odd.decoder.token_embedding.weight.shape[0]
    out["odd_logits"] = forward_logits(odd, mel[:1], LOGIT_TOKENS)
    out["odd"] = decodes(odd, mel, names=("greedy",))
    int8 = build(sd, fields, int8=True)
    out["int8"] = decodes(int8, mel, quantize_kv=True, names=("greedy",))
    os.environ["WHISPER_INT8_MATMUL"] = "1"
    try:
        out["int8_matmul"] = decodes(int8, mel, quantize_kv=True, names=("greedy",))
    finally:
        del os.environ["WHISPER_INT8_MATMUL"]
    return out


def sharding_rank(rank, *args) -> dict:
    """``sharding_cases`` on a 2 (data) x 2 (model) mesh, with this rank's
    coordinates."""
    mesh = make_mesh(n_model=2, n_data=2)
    return {"mesh": (mesh.stage, mesh.data, mesh.model), **sharding_cases(*args, mesh=mesh)}


def env_rank(rank, name: str) -> str | None:
    """The rank's own value of the environment variable ``name``."""
    return os.environ.get(name)


# -- test_torch_pipeline.py ----------------------------------------------------

PIPELINE_MESHES = ((2, 2, 1, 4), (4, 1, 1, 8), (2, 1, 2, 4))  # (stages, data, model, n_micro)


def pipeline_rank(rank, sd, fields, mel, audios) -> dict:
    """The GPipe encoder on each mesh of PIPELINE_MESHES (the whole batch
    through each pipeline), its rank's encoder bytes, and the --pp
    transcription (``BatchTranscriber(encoder_fn=pp_encoder_fn(mesh))``) on
    the last mesh (stages x model)."""
    from whisper_rs_tpu_torch.parallel import BatchTranscriber, encoder_forward_pp, pp_encoder_fn

    out = {}
    for S, D, M, n_micro in PIPELINE_MESHES:
        mesh = make_mesh(n_model=M, n_data=D, n_stage=S)
        model = shard_model(model_of(sd, fields), mesh)
        out[(S, D, M)] = {
            "xa": encoder_forward_pp(model, torch.as_tensor(mel), mesh, n_micro=n_micro).numpy(),
            "encoder_bytes": param_bytes(model.encoder),
            "blocks_bytes": param_bytes(model.encoder.blocks),
            "stage_layers": model.encoder.stage_layers,
        }
    bt = BatchTranscriber(model, SmallTokenizer(), transcribe_options(), batch_size=2,
                          encoder_fn=pp_encoder_fn(mesh))
    out["transcribe"] = outputs_of(bt.run(audios))
    return out


# -- test_torch_ulysses.py -----------------------------------------------------


def ulysses_rank(rank, sd, fields, mel, sd_short, fields_short, mel_short) -> dict:
    """The Ulysses encoder over 2 ranks (x 2 data) and over 4, greedy with it
    through the ``encoder_fn`` seam on the first mesh, and over 4 ranks at
    750 frames, which 4 does not divide (padded, masked by n_valid)."""
    from whisper_rs_tpu_torch.parallel import encoder_forward_ulysses, ulysses_encoder_fn

    out = {}
    for M, D in ((4, 1), (2, 2)):
        mesh = make_mesh(n_model=M, n_data=D)
        model = shard_model(model_of(sd, fields), mesh, tensor_parallel=False)
        out[M] = encoder_forward_ulysses(model, torch.as_tensor(mel), mesh).numpy()
    cfg = filter_config(model.dims.n_vocab)
    initial = np.full((mel.shape[0], 1), SOT)
    r = decode_greedy(model, torch.as_tensor(mel), initial, 1, 0, cfg, GreedyMode(), 8,
                      NO_SPEECH, encoder_fn=ulysses_encoder_fn(mesh))
    out["greedy"] = (r.candidates.numpy(), r.scores.numpy())
    mesh = make_mesh(n_model=4)
    short = shard_model(model_of(sd_short, fields_short), mesh, tensor_parallel=False)
    out["short"] = encoder_forward_ulysses(short, torch.as_tensor(mel_short), mesh).numpy()
    return out


# -- test_torch_multihost.py ---------------------------------------------------


def multihost_rank(rank, sd, fields, seconds) -> dict:
    """One of two "hosts" started by ``initialize_multihost`` over a localhost
    coordinator: it ingests its own audio (seed = rank), encodes it on the
    2-rank data-parallel mesh, gathers every rank's features, and sums a
    per-rank value over the group; then the same gather with every tensor
    taken as a card's, staged through host memory (``collectives.route``
    forced to "stage")."""
    import torch.distributed as dist

    from whisper_rs_tpu_torch.ops.mel import log_mel_file
    from whisper_rs_tpu_torch.audio.mel import pad_or_trim
    from whisper_rs_tpu_torch.parallel import collectives

    mesh = make_mesh(n_data=2)
    model = shard_model(model_of(sd, fields), mesh)
    audio = (np.random.default_rng(rank).standard_normal(16000 * seconds) * 0.1).astype(np.float32)
    mel = pad_or_trim(log_mel_file(audio, model.dims.n_mels, device="cpu"), 3000)
    xa = collectives.all_gather_data(model.encoder(mel[None]), mesh)
    total = torch.tensor([float(xa[rank].double().abs().sum())])
    dist.all_reduce(total)
    collectives.reset_stats()
    plain_route = collectives.route
    collectives.route = lambda device_type, backend: "stage"
    try:
        staged = collectives.all_gather_data(model.encoder(mel[None]), mesh)
    finally:
        collectives.route = plain_route
    return {"mesh": (mesh.stage, mesh.data, mesh.model), "xa": xa.numpy(),
            "total": float(total), "staged": staged.numpy(), "stats": dict(collectives.STATS),
            "local_bytes": xa[0].numel() * xa.element_size()}


# -- test_torch_serve_parallel.py ----------------------------------------------

SERVE_CASES = {
    "plain": {},
    "ladder": dict(temperatures=(0.0, 0.5), logprob_threshold=1.0),
    "words": dict(word_timestamps=True),
}


def serve_rank(rank, sd, fields, audios) -> dict:
    """TP 2 serving, one engine a case of SERVE_CASES: rank 0 runs the
    ServingEngine (batch 2, every file submitted at once) and returns each
    request's output; rank 1 runs ``serve_follower`` and returns the number
    of calls it mirrored before the engine's close() ended it."""
    from whisper_rs_tpu_torch.serve import ServingEngine, serve_follower

    mesh = make_mesh(n_model=2)
    model = shard_model(model_of(sd, fields), mesh)
    tok = SmallTokenizer()
    out = {}
    for case, kw in SERVE_CASES.items():
        opts = transcribe_options(**kw)
        if rank == 0:
            with ServingEngine(model, tok, opts, batch_size=2) as engine:
                handles = [engine.submit(a) for a in audios]
                out[case] = outputs_of([h.result(timeout=300) for h in handles])
        else:
            out[case] = serve_follower(model, tok, opts)
    return out


def start_ranks(fn, world: int, args, timeout: float, **kwargs):
    """Starts ``fn`` on ``world`` ranks (``launch.Ranks``) and waits for them
    on a thread of this process, so the test's own work overlaps the
    ranks': returns the future of their results.  Every rank has started
    (with this process's environment as it is now) when this returns."""
    import concurrent.futures

    from whisper_rs_tpu_torch.parallel.launch import Ranks

    ranks = Ranks(fn, world, args=args, **kwargs)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(ranks.wait, timeout)
    pool.shutdown(wait=False)
    return future


def one_thread(fn, *args, **kwargs):
    """``fn`` with torch on one thread (the suite's workers share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args, **kwargs)
    finally:
        torch.set_num_threads(threads)
