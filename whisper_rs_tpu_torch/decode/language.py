"""Language identification (counterpart of
``whisper_rs_tpu/decode/language.py``): one decoder pass on ``[sot]`` and a
softmax of its logits restricted to the ``<|xx|>`` language tokens.  It
needs a multilingual checkpoint (callers check
``tokenizer.is_multilingual``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..models.whisper import KVCache, Whisper, encoder_forward, precompute_cross_kv


def detect_language_logits(
    model: Whisper, mel: torch.Tensor, sot_id: int, lang_token_ids: torch.Tensor, *,
    kernels: bool = True, encoder_fn=None,
) -> torch.Tensor:
    """mel [B, n_mels, 3000] on the model's device -> [B, n_langs] f32
    language probabilities; ``encoder_fn(model, mel, kernels)`` in the
    encoder's place where given (``parallel``'s pipeline encoder)."""
    xa = encoder_forward(model, mel.to(model.dtype), kernels=kernels, encoder_fn=encoder_fn)
    cross_kv = precompute_cross_kv(model, xa)
    cache = KVCache.init(model.dims, mel.shape[0], xa.dtype, xa.device, n_head=model.decoder.n_head)
    tokens = torch.full((mel.shape[0], 1), sot_id, dtype=torch.long, device=xa.device)
    logits = model.decoder(tokens, 0, cross_kv, cache, kernels=kernels)
    return torch.softmax(logits[:, 0][:, lang_token_ids].float(), dim=-1)


def detect_language(model: Whisper, mel, tokenizer, *, kernels: bool = True,
                    encoder_fn=None) -> List[Dict[str, float]]:
    """Per audio, {language code: probability}, the most likely first; mel
    [n_mels, 3000] or [B, n_mels, 3000] (numpy or tensor).  The languages
    are the tokenizer's own table (99 or 100)."""
    mel = torch.as_tensor(mel).to(model.device)
    if mel.ndim == 2:
        mel = mel[None]
    codes = tokenizer.language_codes
    lang_ids = torch.arange(len(codes), device=model.device) + tokenizer.token_id_sot + 1
    probs = detect_language_logits(model, mel, tokenizer.token_id_sot, lang_ids,
                                   kernels=kernels, encoder_fn=encoder_fn).cpu()
    return [dict(sorted(zip(codes, row.tolist()), key=lambda kv: -kv[1])) for row in probs]
