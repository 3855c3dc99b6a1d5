"""Subtitle/transcript output formatting (SRT, VTT, plain text) from
``TranscribeOutput`` segments (a copy of ``whisper_rs_tpu/utils/formats.py``)."""

from __future__ import annotations

from typing import Iterable


def _ts(seconds: float, sep: str) -> str:
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def to_srt(segments: Iterable) -> str:
    lines = []
    for i, seg in enumerate(segments, 1):
        lines.append(str(i))
        lines.append(f"{_ts(seg.start_time, ',')} --> {_ts(seg.end_time, ',')}")
        lines.append(seg.text.strip())
        lines.append("")
    return "\n".join(lines)


def to_vtt(segments: Iterable) -> str:
    lines = ["WEBVTT", ""]
    for seg in segments:
        lines.append(f"{_ts(seg.start_time, '.')} --> {_ts(seg.end_time, '.')}")
        lines.append(seg.text.strip())
        lines.append("")
    return "\n".join(lines)


def to_text(segments: Iterable) -> str:
    return "\n".join(seg.text.strip() for seg in segments if seg.text.strip())
