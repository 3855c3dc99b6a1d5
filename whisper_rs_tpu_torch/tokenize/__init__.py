"""Text layer: the Whisper tokenizer (pure-Python byte-level BPE) and the
language table."""

from .languages import LANGUAGE_CODES, LANGUAGE_NAMES, LANGUAGES
from .tokenizer import Task, Tokenizer

__all__ = ["LANGUAGES", "LANGUAGE_CODES", "LANGUAGE_NAMES", "Task", "Tokenizer"]
