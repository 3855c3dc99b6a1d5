"""Output formats, the command line's logging, WER and CSV helpers."""

from .csvio import read_csv_2d, write_csv_2d
from .formats import to_srt, to_text, to_vtt
from .wer import edit_distance, iter_librispeech, wer

__all__ = [
    "edit_distance",
    "iter_librispeech",
    "read_csv_2d",
    "to_srt",
    "to_text",
    "to_vtt",
    "wer",
    "write_csv_2d",
]
