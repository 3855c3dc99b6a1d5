"""LibriSpeech WER evaluation with the PyTorch port (counterpart of
``tools/eval_wer.py``: the same flags and output, plus ``--device``).

  python -m whisper_rs_tpu_torch.tools.eval_wer --checkpoint base.en.pt \\
      --librispeech /data/LibriSpeech/test-clean [--limit 100] \\
      [--greedy | --beam 5] [--batch 8] [--quant int8|kv|int8kv] [--device cpu]

Takes any checkpoint ``models.load_checkpoint`` reads and an extracted
LibriSpeech split; transcribes it through ``parallel.batch.BatchTranscriber``
with OpenAI's recipe (the temperature ladder 0, 0.2, ..., 1.0 and the
no-speech threshold 0.6; ``--no-recipe`` for one pass) and prints the
corpus WER and audio-seconds a second.  Exit codes: 0, or 1 where the split
holds no utterance.
"""

from __future__ import annotations

import argparse
import sys
import time

RECIPE = dict(temperatures=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0), no_speech_threshold=0.6)


def add_common_flags(ap: argparse.ArgumentParser) -> None:
    """The flags both tools share with their JAX counterparts, and
    ``--device``."""
    ap.add_argument("--checkpoint", required=True,
                    help="OpenAI .pt, HF checkpoint dir or .npz (auto-detected)")
    ap.add_argument("--librispeech", required=True, help="extracted LibriSpeech split dir")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--no-recipe", action="store_true",
                    help="disable the OpenAI recipe (temperature ladder (0,.2,.4,.6,.8,1.0) "
                    "+ no_speech_threshold=0.6)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, which must be present; cpu runs the "
                    "kernels' plain versions)")


def transcribe_options(args, sample_len=None):
    from ..config import BeamSearchMode, DecodeOptions, GreedyMode, TranscribeOptions

    mode = GreedyMode() if args.greedy else BeamSearchMode(beam_size=args.beam)
    recipe = {} if args.no_recipe else RECIPE
    return TranscribeOptions(decode=DecodeOptions(mode=mode, sample_len=sample_len), **recipe)


def run_wer(model, tokenizer, options, pairs, batch: int, quantize_kv: bool = False,
            progress=None):
    """(corpus WER, audio seconds, wall seconds) of ``pairs`` (audio path,
    transcript) through a fresh ``BatchTranscriber``, ``batch`` files a run;
    a failed file counts as an empty transcript.  ``progress(done, wer)``
    after each run."""
    import torch

    from ..audio.io import load_audio
    from ..parallel.batch import BatchTranscriber
    from ..utils import wer

    transcriber = BatchTranscriber(model, tokenizer, options, batch_size=batch)
    transcriber.decode_task.quantize_kv = quantize_kv
    refs, hyps = [], []
    total_audio_s = 0.0
    t0 = time.perf_counter()
    for i in range(0, len(pairs), batch):
        chunk = pairs[i : i + batch]
        audios = [load_audio(p) for p, _ in chunk]
        total_audio_s += sum(len(a) / 16000.0 for a in audios)
        outs = transcriber.run(audios, raise_on_error=False)
        for (_, ref), out in zip(chunk, outs):
            refs.append(ref)
            hyps.append(out.text if out is not None else "")
        if progress is not None:
            progress(min(i + batch, len(pairs)), wer(refs, hyps))
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return float(wer(refs, hyps)), total_audio_s, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(ap)
    ap.add_argument("--quant", default=None, choices=["int8", "kv", "int8kv"])
    args = ap.parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..models import load_checkpoint, quantize_params
    from ..tokenize import Task, Tokenizer
    from ..utils import iter_librispeech

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model, dims = load_checkpoint(args.checkpoint, dtype=dtype, device=device)
    if args.quant and "int8" in args.quant:
        quantize_params(model)
    tokenizer = Tokenizer.for_dims(dims, Task.TRANSCRIBE)

    pairs = list(iter_librispeech(args.librispeech))
    if args.limit:
        pairs = pairs[: args.limit]
    if not pairs:
        print("no utterances found", file=sys.stderr)
        return 1

    def progress(done, running):
        print(f"[{done}/{len(pairs)}] running WER: {running:.4f}", file=sys.stderr)

    result, audio_s, dt = run_wer(model, tokenizer, transcribe_options(args), pairs, args.batch,
                                  quantize_kv=bool(args.quant and "kv" in args.quant),
                                  progress=progress)
    print(f"WER: {result:.4f} over {len(pairs)} utterances ({audio_s:.0f} audio-s in "
          f"{dt:.1f}s = {audio_s / dt:.1f} audio-s/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
