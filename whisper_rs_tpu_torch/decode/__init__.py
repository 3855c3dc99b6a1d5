"""Window decode, greedy and beam search: filters, prompts, the step loops
and ranking."""

from .filters import FilterConfig, apply_filters
from .loop import DecodeResult, decode_beam, decode_greedy
from .prompt import PREFILL_BUCKETS, build_batch_prompts, prefill_bucket
from .ranker import rank_max_likelihood

__all__ = [
    "PREFILL_BUCKETS",
    "DecodeResult",
    "FilterConfig",
    "apply_filters",
    "build_batch_prompts",
    "decode_beam",
    "decode_greedy",
    "prefill_bucket",
    "rank_max_likelihood",
]
