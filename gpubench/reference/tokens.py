"""The ids a decode suppresses as non-speech (OpenAI's
``Tokenizer.non_speech_tokens``), worked out here from the raw GPT-2
``tokenizer.json`` by byte-level BPE, with no tokenizer of the port.

Every string encoded here is one pre-tokenized piece under GPT-2's pattern
(an optional space, then symbols that are neither letters, digits nor
space), so BPE of the whole string is its encoding.
"""

from __future__ import annotations

import functools
import json
import pathlib
from typing import List, Tuple

SYMBOLS = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
    "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split())
MISC = "♩♪♫♬♭♮♯"


@functools.lru_cache(maxsize=1)
def _byte_chars() -> Tuple[str, ...]:
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    out, extra = [], 0
    for b in range(256):
        if b in keep:
            out.append(chr(b))
        else:
            out.append(chr(256 + extra))
            extra += 1
    return tuple(out)


@functools.lru_cache(maxsize=2)
def _load(path: str):
    model = json.loads(pathlib.Path(path).read_text(encoding="utf-8"))["model"]
    ranks = {}
    for rank, merge in enumerate(model["merges"]):
        a, b = merge.split(" ") if isinstance(merge, str) else merge
        ranks[(a, b)] = rank
    return dict(model["vocab"]), ranks


def bpe(piece: str, path: str) -> List[int]:
    """Ids of one pre-tokenized piece."""
    vocab, ranks = _load(path)
    chars = _byte_chars()
    word = [chars[b] for b in piece.encode("utf-8")]
    while len(word) > 1:
        pairs = [(ranks.get(p, len(ranks)), i) for i, p in enumerate(zip(word, word[1:]))]
        best = min(pairs)[0]
        if best == len(ranks):
            break
        a, b = next(p for p in zip(word, word[1:]) if ranks.get(p) == best)
        merged, i = [], 0
        while i < len(word):
            if i + 1 < len(word) and word[i] == a and word[i + 1] == b:
                merged.append(a + b)
                i += 2
            else:
                merged.append(word[i])
                i += 1
        word = merged
    return [vocab[w] for w in word]


def non_speech_ids(path: str) -> Tuple[int, ...]:
    """Sorted ids: the first tokens of " -" and " '", every symbol (bare and
    after a space) that encodes to one token, and the first token of each
    music glyph."""
    out = {bpe(" -", path)[0], bpe(" '", path)[0]}
    for sym in SYMBOLS + list(MISC):
        for variant in (sym, " " + sym):
            ids = bpe(variant, path)
            if len(ids) == 1 or sym in MISC:
                out.add(ids[0])
    return tuple(sorted(out))
