"""LM serving: prefill once, decode autoregressively with KV cache.

The port of :mod:`repro.serve.lm_serve`. Greedy decoding takes the first
of tied maxima, as ``jnp.argmax`` does. Sampling draws from a
``torch.Generator`` passed in place of the reference's JAX key (one draw
per step from it, where the reference folds the step into the key), so a
sampled sequence is reproducible but not the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.models import transformer as tfm


@torch.no_grad()
def generate(
    cfg: TransformerConfig,
    params: dict,
    prompt_tokens: torch.Tensor,   # [B, S_prompt]
    n_steps: int,
    cache_len: int | None = None,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Greedy (or sampled) generation; returns [B, n_steps] int32 tokens,
    on the prompt's device."""
    B, S = prompt_tokens.shape
    cache_len = cache_len or (S + n_steps)
    logits, caches = tfm.prefill(cfg, params, prompt_tokens, cache_len=cache_len)
    out = []
    tok = _pick(logits, temperature, generator)
    for i in range(n_steps):
        out.append(tok)
        logits, caches = tfm.decode_step(cfg, params, tok, caches, S + i)
        tok = _pick(logits, temperature, generator)
    return torch.cat(out, dim=1)


def _pick(logits: torch.Tensor, temperature: float, generator: torch.Generator | None
          ) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
