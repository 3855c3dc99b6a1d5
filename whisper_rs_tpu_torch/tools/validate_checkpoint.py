"""One-command checkpoint validation with the PyTorch port (counterpart of
``tools/validate_checkpoint.py``: the same flags, verdict and exit codes,
plus ``--device``).

  python -m whisper_rs_tpu_torch.tools.validate_checkpoint \\
      --checkpoint base.en.pt --librispeech /data/LibriSpeech/test-clean \\
      [--limit 100] [--batch 8] [--dtype bfloat16] [--wer-gate 0.06] \\
      [--quant-gate 0.005] [--device cpu]

Runs, against any checkpoint ``models.load_checkpoint`` reads:

  1. LibriSpeech WER at the compute dtype;
  2. the WER with int8 weights (``quantize_params``), with int8 weights and
     int8 K/V (``quantize_kv``), and with int8 weights under the int8×int8
     matmuls (``WHISPER_INT8_MATMUL=1``, set for that run and restored):
     their ΔWER against (1) is the gate for switching each on by default;
  3. word-timestamp sanity on the first utterance (words present, non-empty,
     in time order, inside the audio);
  4. language ID on the first utterance (multilingual checkpoints only).

Prints ONE JSON line on stdout, the verdict, with the JAX tool's keys
(``ok``, ``wer``, ``wer_int8``, ``delta_wer_int8``, ``int8_ok``, ...).
Exit codes: 0 when every gate passes, 3 when one fails, 1 where the split
holds no utterance.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import sys

from .eval_wer import add_common_flags, run_wer, transcribe_options


@contextlib.contextmanager
def int8_matmul(on: bool):
    """``WHISPER_INT8_MATMUL=1`` inside the block where ``on``, the variable as
    it was after it."""
    before = os.environ.get("WHISPER_INT8_MATMUL")
    if on:
        os.environ["WHISPER_INT8_MATMUL"] = "1"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("WHISPER_INT8_MATMUL", None)
        else:
            os.environ["WHISPER_INT8_MATMUL"] = before


def word_timing_sanity(model, tokenizer, options, audio_path) -> dict:
    """Transcribe one utterance with word timestamps and check the words'
    structure (wrong alignment heads give empty, unordered or stray
    words)."""
    from ..audio.io import load_audio
    from ..transcribe import TranscribeTask

    audio = load_audio(audio_path)
    opts = dataclasses.replace(options, word_timestamps=True)
    out = TranscribeTask(model, tokenizer, opts).run(audio)
    words = [w for s in out.segments for w in (s.words or [])]
    audio_s = len(audio) / 16000.0
    checks = {
        "n_segments": len(out.segments),
        "n_words": len(words),
        "has_words": bool(words),
        "words_nonempty": all(w.word.strip() for w in words),
        "monotone": all(a.start <= b.start + 1e-9 for a, b in zip(words, words[1:])),
        "spans_valid": all(0.0 <= w.start <= w.end for w in words),
        "inside_audio": all(w.start <= audio_s + 30.0 for w in words),
    }
    checks["ok"] = bool(checks["has_words"] and checks["words_nonempty"] and checks["monotone"]
                        and checks["spans_valid"] and checks["inside_audio"])
    return checks


def language_id_smoke(model, tokenizer, audio_path) -> dict:
    from ..audio.constants import N_FRAMES
    from ..audio.io import load_audio
    from ..audio.mel import pad_or_trim
    from ..decode.language import detect_language
    from ..ops.mel import log_mel_file

    if not tokenizer.is_multilingual:
        return {"skipped": "english-only checkpoint"}
    mel = log_mel_file(load_audio(audio_path), model.dims.n_mels, device=model.device)
    probs = detect_language(model, pad_or_trim(mel, N_FRAMES).to(model.dtype), tokenizer)[0]
    top = max(probs, key=probs.get)
    return {"top": top, "p": round(float(probs[top]), 4), "ok": bool(probs[top] > 0.0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(ap)
    ap.add_argument("--sample-len", type=int, default=None,
                    help="max tokens per window (smoke-test hook)")
    ap.add_argument("--language", default="en")
    ap.add_argument("--wer-gate", type=float, default=0.06,
                    help="absolute WER above which the verdict fails")
    ap.add_argument("--quant-gate", type=float, default=0.005,
                    help="max ΔWER for int8 / int8-KV / int8x8 to pass (the gate for "
                    "defaulting quantization on)")
    ap.add_argument("--skip-quant", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..models import load_checkpoint, quantize_params
    from ..tokenize import Task, Tokenizer
    from ..utils import iter_librispeech

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model, dims = load_checkpoint(args.checkpoint, dtype=dtype, device=device)
    tokenizer = Tokenizer.for_dims(dims, Task.TRANSCRIBE, language=args.language)
    options = transcribe_options(args, sample_len=args.sample_len)

    pairs = list(iter_librispeech(args.librispeech))
    if args.limit:
        pairs = pairs[: args.limit]
    if not pairs:
        print("no utterances found", file=sys.stderr)
        return 1

    verdict = {
        "checkpoint": args.checkpoint,
        "model_dims": {
            "n_audio_layer": dims.n_audio_layer,
            "n_text_layer": dims.n_text_layer,
            "n_audio_state": dims.n_audio_state,
            "n_vocab": dims.n_vocab,
        },
        "n_utterances": len(pairs),
        "decode": "greedy" if args.greedy else f"beam{args.beam}",
        "dtype": args.dtype,
        "recipe": "openai" if not args.no_recipe else "single-pass",
    }

    def progress(msg):
        print(msg, file=sys.stderr)

    progress(f"[1/4] WER ({args.dtype}) over {len(pairs)} utterances ...")
    wer0, audio_s, dt = run_wer(model, tokenizer, options, pairs, args.batch)
    verdict["wer"] = round(wer0, 4)
    verdict["audio_s_per_s"] = round(audio_s / dt, 1)
    verdict["wer_ok"] = wer0 <= args.wer_gate

    if args.skip_quant:
        verdict["int8_ok"] = verdict["int8_kv_ok"] = None
        verdict["int8_matmul_ok"] = None
    else:
        # quantize_params works in place: the int8 runs take a copy, and the
        # word timings and language ID below the checkpoint's own weights
        qmodel = quantize_params(copy.deepcopy(model))
        runs = (("int8", "int8 weights", False, False),
                ("int8_kv", "int8 weights + int8 KV", True, False),
                ("int8_matmul", "int8x8 matmuls (WHISPER_INT8_MATMUL=1)", False, True))
        for key, what, kv, mm in runs:
            progress(f"[2/4] WER {what} ...")
            with int8_matmul(mm):
                wer_q, _, _ = run_wer(qmodel, tokenizer, options, pairs, args.batch,
                                      quantize_kv=kv)
            verdict[f"wer_{key}"] = round(wer_q, 4)
            verdict[f"delta_wer_{key}"] = round(wer_q - wer0, 4)
            verdict[f"{key}_ok"] = (wer_q - wer0) <= args.quant_gate
        del qmodel

    progress("[3/4] word-timestamp alignment sanity ...")
    verdict["word_timing"] = word_timing_sanity(model, tokenizer, options, pairs[0][0])

    progress("[4/4] language-ID smoke ...")
    verdict["language_id"] = language_id_smoke(model, tokenizer, pairs[0][0])

    gates = [verdict["wer_ok"], verdict["word_timing"]["ok"]]
    if verdict.get("int8_ok") is not None:
        gates += [verdict["int8_ok"], verdict["int8_kv_ok"], verdict["int8_matmul_ok"]]
    if "ok" in verdict["language_id"]:
        gates.append(verdict["language_id"]["ok"])
    verdict["ok"] = all(gates)

    print(json.dumps(verdict))
    return 0 if verdict["ok"] else 3


if __name__ == "__main__":
    sys.exit(main())
