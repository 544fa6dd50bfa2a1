"""Deterministic synthetic LM data.

Port of ``repro/train/data.py``.  The batch for step N is a pure function of
(seed, step), so a run restarted at step N sees the same stream.  The law
is the JAX package's: Zipf(1.1) unigrams over the vocabulary, and with
probability 0.35 a token is replaced by the structured successor of the
token before it, (31 t + shift + 7) mod V with a per-row shift in [0, 17).
The bits come from a CPU ``torch.Generator`` seeded from (seed, step), so a
batch is the same on every device; they cannot be ``jax.random``'s, and
parity tests hand the JAX package's batch to both sides.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_K = 17          # the structured successor's shifts
_MIX = 0.35      # share of structured successors


def _zipf_probs(vocab: int, alpha: float = 1.1) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
    p = ranks ** -alpha
    return p / p.sum()


def make_batch(cfg: ModelConfig, batch: int, seq: int, step: int,
               seed: int = 0) -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: int64 [batch, seq] on the CPU, labels the
    tokens shifted by one."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: frontend inputs are not ported yet (ROADMAP.md §1, "
            "the queue of modules)")
    # the CPU generator keeps 32 bits of a seed: mix (seed, step) into them
    word = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    gen = torch.Generator().manual_seed(int(word))
    V = cfg.vocab_size
    tokens = torch.multinomial(_zipf_probs(V), batch * (seq + 1),
                               replacement=True, generator=gen)
    tokens = tokens.reshape(batch, seq + 1)
    shift = torch.randint(0, _K, (batch, 1), generator=gen)
    structured = (tokens[:, :-1] * 31 + shift + 7) % V
    mix = torch.rand(structured.shape, generator=gen) < _MIX
    nxt = torch.where(mix, structured, tokens[:, 1:])
    tokens = torch.cat([tokens[:, :1], nxt], dim=1)
    return {"tokens": tokens[:, :-1].contiguous(),
            "labels": tokens[:, 1:].contiguous()}
