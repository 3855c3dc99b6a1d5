"""Output formats and the command line's logging."""

from .formats import to_srt, to_text, to_vtt

__all__ = ["to_srt", "to_text", "to_vtt"]
