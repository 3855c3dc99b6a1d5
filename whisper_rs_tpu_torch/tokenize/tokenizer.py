"""Whisper tokenizer in pure Python: GPT-2 byte-level BPE, Whisper's special
tokens and its virtual timestamp tokens (counterpart of
``whisper_rs_tpu/tokenize/tokenizer.py``, which wraps Hugging Face
``tokenizers``; the port needs neither that package nor ``regex``).

It reads the same tokenizer file, a Hugging Face ``tokenizer.json`` of the
GPT-2 BPE (by default the port's own copy of the vocabulary,
``whisper_rs_tpu_torch/assets/gpt2.json``, read as a file), and gives the same ids
and text as the Hugging Face tokenizer that file describes:

  * ``encode``: the special tokens in the text are matched first, whole,
    leftmost and longest first; every other stretch is split by GPT-2's
    pre-tokenizer pattern (``_pre_tokenize``, a scanner over
    ``unicodedata`` categories in the place of the ``\\p{L}``/``\\p{N}``
    pattern), mapped byte by byte to GPT-2's printable characters and
    merged by rank;
  * ``decode``: special and timestamp ids dropped, the bytes joined and
    decoded as UTF-8 with each invalid sequence replaced by U+FFFD, as the
    Rust ``String::from_utf8_lossy`` of Hugging Face's ByteLevel decoder
    does.

The special tokens are added in the reference's order: ``<|startoftranscript|>``,
the 99 (or 100) ``<|xx|>`` language tags, then ``<|translate|>``,
``<|transcribe|>``, ``<|startoflm|>``, ``<|startofprev|>``, ``<|nospeech|>``,
``<|notimestamps|>``; a string the vocabulary already has keeps its id, a
new one takes the next free id.  Timestamp ids follow the last special id.
"""

from __future__ import annotations

import enum
import functools
import json
import os
import pathlib
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

from .languages import language_table, num_languages_for_vocab

# the GPT-2 vocabulary shipped with the port (package data), read as a file
_VENDORED_JSON = pathlib.Path(__file__).resolve().parents[1] / "assets" / "gpt2.json"


class Task(enum.Enum):
    LANGUAGE_ID = "language_id"
    TRANSLATE = "translate"
    TRANSCRIBE = "transcribe"


_SPECIALS_TAIL = (
    "<|translate|>",
    "<|transcribe|>",
    "<|startoflm|>",
    "<|startofprev|>",
    "<|nospeech|>",
    "<|notimestamps|>",
)

# Symbols whose single-token encodings are suppressed to avoid non-speech
# annotations (the reference's list).
_NON_SPEECH_SYMBOLS = (
    '"', "#", "(", ")", "*", "+", "/", ":", ";", "<", "=", ">", "@", "[",
    "\\", "]", "^", "_", "`", "{", "|", "}", "~", "「", "」", "『", "』",
    "<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", '("', "((",
    "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪",
)

# U+2640-U+267F misc symbols: their first BPE token is suppressed (the
# 3-byte UTF-8 forms share their first two bytes).
_NON_SPEECH_MISC = ("♩", "♪", "♫", "♬", "♭", "♮", "♯")

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache(maxsize=1)
def _byte_chars() -> Tuple[str, ...]:
    """GPT-2's map of the 256 bytes to printable characters: the printable
    Latin-1 bytes map to themselves, the rest to U+0100 onwards."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    chars, extra = {}, 0
    for b in range(256):
        if b in keep:
            chars[b] = chr(b)
        else:
            chars[b] = chr(256 + extra)
            extra += 1
    return tuple(chars[b] for b in range(256))


def _is_space(c: str) -> bool:
    """The pattern's ``\\s`` (Oniguruma's, in Unicode mode): tab to carriage
    return, NEL, and the space, line and paragraph separators."""
    return c in "\t\n\x0b\x0c\r\x85" or unicodedata.category(c) in ("Zs", "Zl", "Zp")


def _char_class(c: str) -> str:
    """"L" (``\\p{L}``), "N" (``\\p{N}``), "S" (``\\s``) or "O" (any other)."""
    if _is_space(c):
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in ("L", "N") else "O"


def _pre_tokenize(text: str) -> List[str]:
    """GPT-2's split, as its pattern ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+|
    ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`` matches: at each position
    the first alternative that matches, each run as long as it goes."""
    pieces, i, n = [], 0, len(text)
    classes = [_char_class(c) for c in text]
    while i < n:
        if text[i] == "'":
            con = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
            if con is not None:
                pieces.append(con)
                i += len(con)
                continue
        if text[i] == " " and i + 1 < n and classes[i + 1] != "S":
            start = i + 1  # an optional leading space joins the run
        elif classes[i] != "S":
            start = i
        else:
            j = i
            while j < n and classes[j] == "S":
                j += 1
            # \s+(?!\S): the run less its last space when a non-space follows
            end = j if j == n or j - i == 1 else j - 1
            pieces.append(text[i:end])
            i = end
            continue
        cls = classes[start]
        j = start
        while j < n and classes[j] == cls:
            j += 1
        pieces.append(text[i:j])
        i = j
    return pieces


@functools.lru_cache(maxsize=4)
def _load(path: str) -> tuple:
    """(vocab {token: id}, merge ranks {(a, b): rank}, added tokens
    ((content, id, special), ...)) of a tokenizer.json."""
    data = json.loads(pathlib.Path(path).read_text(encoding="utf-8"))
    model = data["model"]
    if model.get("type") != "BPE":
        raise ValueError(f"{path}: a BPE model is needed, not {model.get('type')}")
    vocab = dict(model["vocab"])
    ranks = {}
    for rank, merge in enumerate(model["merges"]):
        a, b = merge.split(" ") if isinstance(merge, str) else merge
        ranks[(a, b)] = rank
    added = tuple((t["content"], t["id"], bool(t.get("special")))
                  for t in data.get("added_tokens", ()))
    return vocab, ranks, added


class Tokenizer:
    """The Whisper tokenizer: every control token's id as an attribute,
    ``encode``/``decode``, the SOT sequence and the suppression lists."""

    def __init__(
        self,
        task: Task = Task.TRANSCRIBE,
        tokenizer_json: Optional[str] = None,
        language: str = "en",
        num_languages: int = 99,
    ):
        path = tokenizer_json
        if path is None:
            candidates = (os.environ.get("WHISPER_TOKENIZER_JSON"), _VENDORED_JSON)
            path = next((p for p in candidates if p and pathlib.Path(p).exists()), None)
        if path is None:
            raise FileNotFoundError(
                "no tokenizer json found; set WHISPER_TOKENIZER_JSON or pass tokenizer_json="
            )
        vocab, self._ranks, added = _load(str(path))
        self._vocab = vocab

        self.languages = language_table(num_languages)
        self.language_codes = tuple(code for code, _ in self.languages)
        self.num_languages = num_languages
        specials = (["<|startoftranscript|>"] + [f"<|{code}|>" for code in self.language_codes]
                    + list(_SPECIALS_TAIL))

        # added tokens: a string the vocabulary has keeps its id; a new one
        # takes the next id past the vocabulary and every added id
        self._added: Dict[str, int] = {}
        special_ids = set()
        for content, _, special in added:
            self._add(content, special, special_ids)
        for content in specials:
            self._add(content, True, special_ids)
        self._special_ids = frozenset(special_ids)
        self._id_to_token = {i: t for t, i in vocab.items()}
        self._id_to_token.update({i: t for t, i in self._added.items()})
        by_length = sorted(self._added, key=len, reverse=True)
        self._added_re = re.compile("|".join(re.escape(t) for t in by_length))
        self._byte_of = {c: b for b, c in enumerate(_byte_chars())}
        self._cache: Dict[str, Tuple[int, ...]] = {}

        self.task = task
        self.language = language
        self.token_id_sot = self.token_to_id("<|startoftranscript|>")
        self.token_id_eot = self.token_to_id("<|endoftext|>")
        self.token_id_translate = self.token_to_id("<|translate|>")
        self.token_id_transcribe = self.token_to_id("<|transcribe|>")
        self.token_id_no_timestamps = self.token_to_id("<|notimestamps|>")
        self.token_id_no_speech = self.token_to_id("<|nospeech|>")
        self.token_id_startofprev = self.token_to_id("<|startofprev|>")
        self.token_id_startoflm = self.token_to_id("<|startoflm|>")
        # virtual timestamp tokens start right after the last special token
        self.token_id_ts_begin = max(self.token_to_id(s) for s in specials) + 1

    def _add(self, content: str, special: bool, special_ids: set) -> None:
        if content in self._added:
            tid = self._added[content]
        elif content in self._vocab:
            tid = self._vocab[content]
        else:
            tid = max([len(self._vocab) - 1, *self._added.values()]) + 1
        self._added[content] = tid
        if special:
            special_ids.add(tid)

    @classmethod
    def for_dims(cls, dims, task: Task = Task.TRANSCRIBE,
                 tokenizer_json: Optional[str] = None, language: str = "en"):
        """The tokenizer of a ModelDims' vocab (99 languages, or 100 for
        large-v3's n_vocab 51866, whose <|yue|> shifts the later ids)."""
        return cls(task, tokenizer_json=tokenizer_json, language=language,
                   num_languages=num_languages_for_vocab(dims.n_vocab))

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._added:
            return self._added[token]
        return self._vocab.get(token)

    # -- encode / decode ----------------------------------------------------

    def _bpe(self, piece: str) -> Tuple[int, ...]:
        """Ids of one pre-tokenized piece: its bytes as GPT-2 characters,
        merged pair by pair, the lowest rank first, every occurrence of the
        pair from the left."""
        ids = self._cache.get(piece)
        if ids is not None:
            return ids
        chars = _byte_chars()
        word = [chars[b] for b in piece.encode("utf-8")]
        ranks = self._ranks
        while len(word) > 1:
            best = min((ranks.get(p, len(ranks)), p) for p in zip(word, word[1:]))
            if best[0] == len(ranks):
                break
            a, b = best[1]
            merged, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        ids = tuple(self._vocab[w] for w in word)
        self._cache[piece] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        pos = 0
        for m in self._added_re.finditer(text):
            for piece in _pre_tokenize(text[pos : m.start()]):
                ids.extend(self._bpe(piece))
            ids.append(self._added[m.group()])
            pos = m.end()
        for piece in _pre_tokenize(text[pos:]):
            ids.extend(self._bpe(piece))
        return ids

    def decode(self, token_ids: Sequence[int]) -> str:
        """Text of ``token_ids``, special and virtual timestamp ids dropped."""
        data = bytearray()
        for t in token_ids:
            t = int(t)
            if t >= self.token_id_ts_begin or t in self._special_ids:
                continue
            token = self._id_to_token.get(t)
            if token is None:
                continue
            if all(c in self._byte_of for c in token):
                data.extend(self._byte_of[c] for c in token)
            else:
                data.extend(token.encode("utf-8"))
        # each maximal invalid UTF-8 sequence becomes one U+FFFD, as in
        # Rust's String::from_utf8_lossy (the same Unicode practice)
        return bytes(data).decode("utf-8", "replace")

    def decode_with_timestamps(self, token_ids: Sequence[int]) -> str:
        """Decode, rendering timestamp ids as ``<|t.tt|>`` markers."""
        out, chunk = [], []
        for t in token_ids:
            t = int(t)
            if t >= self.token_id_ts_begin:
                if chunk:
                    out.append(self.decode(chunk))
                    chunk = []
                out.append(f"<|{(t - self.token_id_ts_begin) * 0.02:.2f}|>")
            else:
                chunk.append(t)
        if chunk:
            out.append(self.decode(chunk))
        return "".join(out)

    # -- control sequences --------------------------------------------------

    def sequence_sot(self) -> List[int]:
        """``[sot]`` for English-only transcription, else ``[sot, <|lang|>,
        <|task|>]``."""
        if self.task == Task.TRANSCRIBE and self.language == "en" and not self.is_multilingual:
            return [self.token_id_sot]
        lang_id = self.token_to_id(f"<|{self.language}|>")
        if lang_id is None:
            raise ValueError(f"unknown language {self.language!r}")
        task_id = (self.token_id_translate if self.task == Task.TRANSLATE
                   else self.token_id_transcribe)
        return [self.token_id_sot, lang_id, task_id]

    @property
    def is_multilingual(self) -> bool:
        # the en-only GPT-2 vocab has 50257 base tokens; multilingual 50258+
        return self.token_to_id("<|endoftext|>") != 50256

    @functools.cached_property
    def _non_speech(self) -> Tuple[int, ...]:
        enc = self.encode
        result = [enc(" -")[0], enc(" '")[0]]
        for sym in _NON_SPEECH_SYMBOLS:
            for variant in (sym, " " + sym):
                ids = enc(variant)
                if len(ids) == 1:
                    result.append(ids[0])
        for sym in _NON_SPEECH_MISC:
            for variant in (sym, " " + sym):
                result.append(enc(variant)[0])
        return tuple(sorted(set(result)))

    def non_speech_tokens(self) -> tuple:
        """Token ids suppressed so the model avoids speaker tags and music
        glyphs: the first tokens of ``" -"`` and ``" '"``, each symbol (bare
        and after a space) that encodes to one token, and the first token of
        each U+2640-U+267F glyph."""
        return self._non_speech

    @property
    def token_id_space(self) -> int:
        """First token of ``" "`` (the suppress-blank filter's)."""
        return self.encode(" ")[0]
