"""Whisper language table (counterpart of
``whisper_rs_tpu/tokenize/languages.py``, copied: the port imports nothing
of the JAX package).

The canonical OpenAI order: it fixes the ``<|xx|>`` token ids, so
``<|en|>`` is always sot + 1.
"""

# (code, name) in OpenAI's canonical order — the order determines token IDs.
LANGUAGES = (
    ("en", "english"),
    ("zh", "chinese"),
    ("de", "german"),
    ("es", "spanish"),
    ("ru", "russian"),
    ("ko", "korean"),
    ("fr", "french"),
    ("ja", "japanese"),
    ("pt", "portuguese"),
    ("tr", "turkish"),
    ("pl", "polish"),
    ("ca", "catalan"),
    ("nl", "dutch"),
    ("ar", "arabic"),
    ("sv", "swedish"),
    ("it", "italian"),
    ("id", "indonesian"),
    ("hi", "hindi"),
    ("fi", "finnish"),
    ("vi", "vietnamese"),
    ("he", "hebrew"),
    ("uk", "ukrainian"),
    ("el", "greek"),
    ("ms", "malay"),
    ("cs", "czech"),
    ("ro", "romanian"),
    ("da", "danish"),
    ("hu", "hungarian"),
    ("ta", "tamil"),
    ("no", "norwegian"),
    ("th", "thai"),
    ("ur", "urdu"),
    ("hr", "croatian"),
    ("bg", "bulgarian"),
    ("lt", "lithuanian"),
    ("la", "latin"),
    ("mi", "maori"),
    ("ml", "malayalam"),
    ("cy", "welsh"),
    ("sk", "slovak"),
    ("te", "telugu"),
    ("fa", "persian"),
    ("lv", "latvian"),
    ("bn", "bengali"),
    ("sr", "serbian"),
    ("az", "azerbaijani"),
    ("sl", "slovenian"),
    ("kn", "kannada"),
    ("et", "estonian"),
    ("mk", "macedonian"),
    ("br", "breton"),
    ("eu", "basque"),
    ("is", "icelandic"),
    ("hy", "armenian"),
    ("ne", "nepali"),
    ("mn", "mongolian"),
    ("bs", "bosnian"),
    ("kk", "kazakh"),
    ("sq", "albanian"),
    ("sw", "swahili"),
    ("gl", "galician"),
    ("mr", "marathi"),
    ("pa", "punjabi"),
    ("si", "sinhala"),
    ("km", "khmer"),
    ("sn", "shona"),
    ("yo", "yoruba"),
    ("so", "somali"),
    ("af", "afrikaans"),
    ("oc", "occitan"),
    ("ka", "georgian"),
    ("be", "belarusian"),
    ("tg", "tajik"),
    ("sd", "sindhi"),
    ("gu", "gujarati"),
    ("am", "amharic"),
    ("yi", "yiddish"),
    ("lo", "lao"),
    ("uz", "uzbek"),
    ("fo", "faroese"),
    ("ht", "haitian creole"),
    ("ps", "pashto"),
    ("tk", "turkmen"),
    ("nn", "nynorsk"),
    ("mt", "maltese"),
    ("sa", "sanskrit"),
    ("lb", "luxembourgish"),
    ("my", "myanmar"),
    ("bo", "tibetan"),
    ("tl", "tagalog"),
    ("mg", "malagasy"),
    ("as", "assamese"),
    ("tt", "tatar"),
    ("haw", "hawaiian"),
    ("ln", "lingala"),
    ("ha", "hausa"),
    ("ba", "bashkir"),
    ("jw", "javanese"),
    ("su", "sundanese"),
)

LANGUAGE_CODES = tuple(code for code, _ in LANGUAGES)
LANGUAGE_NAMES = dict(LANGUAGES)

# large-v3 / large-v3-turbo (n_vocab 51866) append a 100th language token
# <|yue|> after <|su|>; every other checkpoint family has exactly 99.
LANGUAGES_V3 = LANGUAGES + (("yue", "cantonese"),)


def language_table(num_languages: int):
    """The (code, name) table for a model with `num_languages` languages."""
    if num_languages == len(LANGUAGES):
        return LANGUAGES
    if num_languages == len(LANGUAGES_V3):
        return LANGUAGES_V3
    raise ValueError(f"unsupported language count {num_languages}")


def num_languages_for_vocab(n_vocab: int) -> int:
    """Languages in a checkpoint's special-token block, from its vocab size.

    51864 (en-only) and 51865 (multilingual) carry 99 language tokens;
    51866 (large-v3 family) carries 100 (adds <|yue|>).
    """
    return 100 if n_vocab >= 51866 else 99
