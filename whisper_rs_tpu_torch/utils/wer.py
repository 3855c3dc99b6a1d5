"""Word error rate and the LibriSpeech split reader (a copy of
``whisper_rs_tpu/utils/wer.py``, so that the port imports nothing of the
JAX package).  A split is a directory of ``.flac``/``.wav`` files with
their ``*.trans.txt`` transcripts, as LibriSpeech ships it."""

from __future__ import annotations

import pathlib
import re
from typing import Iterable, List, Tuple


def _normalize(text: str) -> List[str]:
    """Basic English normalization: case-insensitive, punctuation stripped
    (LibriSpeech transcripts are bare uppercase words)."""
    text = re.sub(r"[^a-zA-Z' ]+", " ", text)
    return text.upper().split()


def edit_distance(ref: List[str], hyp: List[str]) -> int:
    """Word-level Levenshtein distance (two-row DP)."""
    if not ref:
        return len(hyp)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(
                prev[j] + 1,  # deletion
                cur[j - 1] + 1,  # insertion
                prev[j - 1] + (r != h),  # substitution
            )
        prev = cur
    return prev[-1]


def wer(refs: Iterable[str], hyps: Iterable[str]) -> float:
    """Corpus WER: total edits / total reference words."""
    edits = 0
    words = 0
    for ref, hyp in zip(refs, hyps):
        r, h = _normalize(ref), _normalize(hyp)
        edits += edit_distance(r, h)
        words += len(r)
    return edits / max(words, 1)


def iter_librispeech(split_dir: str) -> Iterable[Tuple[pathlib.Path, str]]:
    """Yield (audio_path, transcript) pairs from a LibriSpeech split dir."""
    root = pathlib.Path(split_dir)
    for trans in sorted(root.rglob("*.trans.txt")):
        table = {}
        for line in trans.read_text().splitlines():
            utt_id, _, text = line.partition(" ")
            table[utt_id] = text.strip()
        for utt_id, text in table.items():
            for ext in (".flac", ".wav"):
                p = trans.parent / (utt_id + ext)
                if p.exists():
                    yield p, text
                    break
