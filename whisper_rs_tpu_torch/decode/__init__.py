"""Window decode, greedy (argmax or sampled, ``rng``) and beam search:
filters, prompts, the step loops, ranking, ``DecodeTask``, language
identification and word alignment (``align``)."""

from .filters import FilterConfig, apply_filters
from .language import detect_language
from .loop import DecodeResult, decode_beam, decode_greedy
from .prompt import PREFILL_BUCKETS, build_batch_prompts, prefill_bucket
from .ranker import rank_max_likelihood
from .task import DecodeOutput, DecodeTask

__all__ = [
    "PREFILL_BUCKETS",
    "DecodeOutput",
    "DecodeResult",
    "DecodeTask",
    "FilterConfig",
    "apply_filters",
    "build_batch_prompts",
    "decode_beam",
    "decode_greedy",
    "detect_language",
    "prefill_bucket",
    "rank_max_likelihood",
]
