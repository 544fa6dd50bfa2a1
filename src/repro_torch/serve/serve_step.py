"""Serving: prefill and single-token decode steps with explicit caches.

Port of ``repro/serve/serve_step.py``.  The model holds its weights, so a
step takes tokens and the cache, and a decode step takes its position as a
host int: nothing in a step waits on the device.  The caches are written
in place and returned for symmetry with the JAX steps.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.modeling.model import Model


def make_prefill_step(model: Model) -> Callable:
    """(tokens [B, S], cache) -> (last-position logits [B, V], cache)."""
    def prefill_step(tokens, cache):
        logits, cache = model(tokens, mode="prefill", pos0=0, cache=cache)
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """(tokens [B], pos, cache) -> (logits [B, V], cache).  ``pos`` is the
    absolute position of the incoming token (the number of tokens already
    in the cache)."""
    def decode_step(tokens, pos: int, cache):
        logits, cache = model(tokens[:, None], mode="decode", pos0=int(pos),
                              cache=cache)
        return logits[:, 0], cache
    return decode_step


@torch.inference_mode()
def greedy_generate(model: Model, prompt: torch.Tensor, max_new: int,
                    max_seq: int) -> torch.Tensor:
    """Greedy autoregressive loop: prompt [B, S0] -> tokens [B, max_new]."""
    B, S0 = prompt.shape
    cache = model.init_cache(B, max_seq)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, cache = prefill(prompt, cache)
    toks = [logits.argmax(-1)]
    for pos in range(S0, S0 + max_new - 1):
        logits, cache = decode(toks[-1], pos, cache)
        toks.append(logits.argmax(-1))
    return torch.stack(toks, dim=1)
