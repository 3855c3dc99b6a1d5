"""Command-line transcription with the PyTorch port (counterpart of
``whisper_rs_tpu/cli.py``: the same flags, output and exit codes, plus
``--device`` and ``--dist-backend``).  Defaults: beam 5, patience 1.0,
timestamps on, blank and non-speech suppression, max_initial_timestamp
1.0 s, bf16.

Usage:
  whisper-rs-tpu-torch AUDIO.wav --checkpoint base.en.pt \\
      [--greedy] [--beam 5] [--json | --format srt|vtt|txt] [--device cpu]
  python -m whisper_rs_tpu_torch.cli ...

Tensor and pipeline parallelism (``--tp``, ``--pp``) run one process a
rank, started by torchrun, whose ``WORLD_SIZE`` must be a multiple of
``tp * pp`` (the rest splits the batch):
  torchrun --nproc-per-node 2 -m whisper_rs_tpu_torch.cli AUDIO.wav \\
      --checkpoint base.en.pt --tp 2 [--dist-backend gloo]
Each rank loads the checkpoint, keeps its shard and transcribes every file;
rank 0 alone prints.  NCCL (the default on the card) takes one card a
rank; ``--dist-backend gloo`` lets ranks share a card.

OpenAI's transcription recipe: ``--temperatures 0,0.2,0.4,0.6,0.8,1.0
--no-speech-threshold 0.6 --word-timestamps``.  Exit codes: 0 when every
file was transcribed, 1 when a file failed to load or transcribe (the
others are still processed), 2 for an invalid combination of options.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="whisper_rs_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("audio", nargs="+", help="audio file(s): wav, flac, mp3 (libmpg123)")
    p.add_argument("--checkpoint", required=True,
                   help="OpenAI whisper .pt file, HF transformers checkpoint dir, or .npz")
    p.add_argument("--tokenizer", default=None, help="tokenizer json (gpt2)")
    p.add_argument("--language", default="en",
                   help="ISO code, or 'auto' to detect per file (multilingual models)")
    p.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    p.add_argument("--greedy", action="store_true", help="greedy decode instead of beam")
    p.add_argument("--sample-len", type=int, default=None, help="max tokens per window")
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--patience", type=float, default=1.0)
    p.add_argument("--length-penalty", type=float, default=None)
    p.add_argument("--max-initial-timestamp", type=float, default=1.0)
    p.add_argument("--no-timestamps", action="store_true")
    p.add_argument("--word-timestamps", action="store_true",
                   help="per-word timings via cross-attention DTW alignment (one extra "
                   "decoder pass per 30s window)")
    p.add_argument("--no-condition-on-prev-text", action="store_true")
    p.add_argument("--initial-prompt", default=None)
    p.add_argument("--temperatures", default=None,
                   help="comma-separated temperature fallback ladder (OpenAI recipe: "
                   "0,0.2,0.4,0.6,0.8,1.0); a window failing the quality checks "
                   "(compression ratio / avg logprob) is retried at the next rung. "
                   "Default: a single pass at t=0")
    p.add_argument("--no-speech-threshold", type=float, default=None,
                   help="skip a window as silence when no_speech_prob exceeds this AND "
                   "avg_logprob < --logprob-threshold (OpenAI recipe: 0.6). Default: never")
    p.add_argument("--logprob-threshold", type=float, default=-1.0,
                   help="avg-logprob quality floor of the temperature ladder and the "
                   "no-speech skip (OpenAI recipe: -1.0)")
    p.add_argument("--compression-ratio-threshold", type=float, default=2.4,
                   help="zlib compression-ratio ceiling of the temperature ladder "
                   "(degenerate-repetition detector; OpenAI recipe: 2.4)")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--quant", default=None, choices=["int8"],
                   help="weight-only quantization (halves the weights' memory traffic)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (processes started by torchrun)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages over the encoder block stack (composes with "
                   "--tp: the mesh is stage x data x model)")
    p.add_argument("--batch", type=int, default=1,
                   help="transcribe files through the batch driver, N windows per decode "
                   "call (throughput mode for many files; requires an explicit --language)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda, which must be present; cpu "
                   "runs the kernels' plain versions)")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend of a torchrun launch (default: nccl on "
                   "cuda, gloo on cpu; gloo lets ranks share a card)")
    p.add_argument("--json", action="store_true", help="emit JSON output")
    p.add_argument("--format", default=None, choices=["srt", "vtt", "txt"],
                   help="subtitle/transcript output format (overrides default listing)")
    return p


def _payload(path, out, language) -> dict:
    segments = []
    for s in out.segments:
        seg = {"start": s.start_time, "end": s.end_time, "text": s.text}
        if s.words is not None:
            seg["words"] = [{"word": w.word, "start": w.start, "end": w.end} for w in s.words]
        segments.append(seg)
    return {"file": path, "language": language, "text": out.text, "segments": segments}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    per_replica = args.tp * args.pp
    if args.tp < 1 or args.pp < 1 or world % per_replica:
        print(f"--tp {args.tp} --pp {args.pp} take a multiple of {per_replica} processes, one a "
              f"rank, and WORLD_SIZE is {world}: launch with torchrun --nproc-per-node "
              f"{per_replica} -m whisper_rs_tpu_torch.cli ...", file=sys.stderr)
        return 2
    if world == 1:
        return _main(args, None)

    import torch.distributed as dist

    from .device import resolve_device
    from .parallel.distributed import initialize_multihost, rank_device

    device = resolve_device(args.device)
    try:
        initialize_multihost(backend=args.dist_backend, device=device)
    except ValueError as e:
        print(f"{e}", file=sys.stderr)
        return 2
    try:
        return _main(args, rank_device(device))
    finally:
        dist.destroy_process_group()


def _main(args, device) -> int:
    """The transcription of ``main`` (``device`` this rank's, under a
    process group; None: ``--device``)."""
    import torch

    from .audio.constants import N_FRAMES, SAMPLE_RATE
    from .audio.io import load_audio
    from .audio.mel import pad_or_trim
    from .config import BeamSearchMode, DecodeOptions, GreedyMode, TranscribeOptions
    from .decode.language import detect_language
    from .device import resolve_device
    from .models import load_checkpoint, quantize_params
    from .ops.mel import log_mel_file
    from .tokenize import Task, Tokenizer
    from .transcribe import TranscribeTask
    from .utils.debug import log, step_timer
    from .utils.formats import to_srt, to_text, to_vtt

    group = device is not None
    device = device or resolve_device(args.device)
    leader = not group or torch.distributed.get_rank() == 0
    if not leader:
        log.setLevel("WARNING")

    def say(*what, **kw):  # only rank 0 prints
        if leader:
            print(*what, **kw)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    with step_timer("load checkpoint", device=device):
        model, dims = load_checkpoint(args.checkpoint, dtype=dtype, device=device)
    if args.quant == "int8":
        quantize_params(model)
    encoder_fn = None
    if group:
        from .parallel import make_mesh, pp_encoder_fn, shard_model

        mesh = make_mesh(n_model=args.tp, n_stage=args.pp)
        shard_model(model, mesh)
        log.info("sharded the model over %s", mesh)
        if args.pp > 1:
            encoder_fn = pp_encoder_fn(mesh)

    detect = args.language == "auto"
    tokenizer = Tokenizer.for_dims(
        dims, Task.TRANSLATE if args.task == "translate" else Task.TRANSCRIBE,
        tokenizer_json=args.tokenizer, language="en" if detect else args.language,
    )
    if detect and not tokenizer.is_multilingual:
        say("--language auto requires a multilingual checkpoint", file=sys.stderr)
        return 2

    mode = GreedyMode() if args.greedy else BeamSearchMode(beam_size=args.beam,
                                                           patience=args.patience)
    temperatures = None
    if args.temperatures:
        temperatures = tuple(float(t) for t in args.temperatures.split(",") if t.strip())
        if temperatures == (0.0,):
            temperatures = None  # one t=0 pass with the primary task
    options = TranscribeOptions(
        decode=DecodeOptions(
            mode=mode, sample_len=args.sample_len, length_penalty=args.length_penalty,
            max_initial_timestamp=args.max_initial_timestamp, timestamps=not args.no_timestamps,
        ),
        initial_prompt_text=args.initial_prompt,
        condition_on_prev_text=not args.no_condition_on_prev_text,
        word_timestamps=args.word_timestamps,
        temperatures=temperatures,
        no_speech_threshold=args.no_speech_threshold,
        logprob_threshold=args.logprob_threshold,
        compression_ratio_threshold=args.compression_ratio_threshold,
    )

    def emit(path, out, detected):
        if args.format:
            fmt = {"srt": to_srt, "vtt": to_vtt, "txt": to_text}[args.format]
            say(fmt(out.segments))
        elif args.json:
            say(json.dumps(_payload(path, out, detected or args.language)))
        else:
            say(f"== {path}")
            for s in out.segments:
                say(f"[{s.start_time:7.2f} -> {s.end_time:7.2f}] {s.text}")

    if args.batch > 1:
        if detect:
            say("--batch requires an explicit --language (one decode config is shared by "
                "the whole batch)", file=sys.stderr)
            return 2
        from .parallel.batch import BatchTranscriber

        rc = 0
        paths, audios = [], []
        for path in args.audio:
            try:
                audios.append(load_audio(path))
                paths.append(path)
            except Exception as e:  # a file that fails to load fails alone
                say(f"{path}: failed to load: {e}", file=sys.stderr)
                rc = 1
        if not paths:
            return rc
        bt = BatchTranscriber(model, tokenizer, options, batch_size=args.batch,
                              encoder_fn=encoder_fn)
        secs = sum(len(a) for a in audios) / SAMPLE_RATE
        with step_timer(f"batch transcribe {len(paths)} files", audio_seconds=secs,
                        device=device):
            outs = bt.run(audios, raise_on_error=False)
        for path, out in zip(paths, outs):
            if out is None:
                say(f"{path}: transcription failed", file=sys.stderr)
                rc = 1
            else:
                emit(path, out, None)
        return rc

    task = TranscribeTask(model, tokenizer, options, encoder_fn=encoder_fn)
    rc = 0
    for path in args.audio:
        try:
            audio = load_audio(path)
        except Exception as e:  # a file that fails to load fails alone
            say(f"{path}: failed to load: {e}", file=sys.stderr)
            rc = 1
            continue
        detected = None
        if detect:
            # the language of the file's first 30 s window
            mel = pad_or_trim(log_mel_file(audio, dims.n_mels, device=device), N_FRAMES)
            probs = detect_language(model, mel, tokenizer, encoder_fn=encoder_fn)[0]
            detected = max(probs, key=probs.get)
            tokenizer.language = detected
            log.info("detected language %s (p=%.2f) for %s", detected, probs[detected], path)
        secs = len(audio) / SAMPLE_RATE
        with step_timer(f"transcribe {path}", audio_seconds=secs, device=device):
            out = task.run(audio)
        emit(path, out, detected)
    return rc


def entrypoint() -> None:
    """console_scripts hook (pyproject [project.scripts])."""
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
