"""Error-feedback int8 gradient compression: the lossy channel of a
data-parallel reduce, as a gradient hook of the train step.

Port of ``compress_decompress`` and ``make_ef_compressor`` of
``repro/distributed/compression.py``: per-leaf symmetric int8 quantization
with per-block scales (max |x| / 127 over blocks of 256), rounding half to
even as ``jnp.round`` does, and the error-feedback residual of step t added
back into the gradient at step t + 1.  The collective itself
(``quantized_psum``) needs more than one card and is not ported.
"""
from __future__ import annotations

from typing import Dict

import torch


def _quantize(x: torch.Tensor, block: int = 256):
    """Symmetric int8 with per-block scales: (q int8, scale, shape, pad)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale, x.shape, pad


def _dequantize(q, scale, shape, pad) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compress_decompress(x: torch.Tensor, block: int = 256):
    """(x_hat, err): the round trip through the int8 channel and the
    residual err = x - x_hat."""
    x_hat = _dequantize(*_quantize(x, block))
    return x_hat, x - x_hat


def make_ef_compressor(block: int = 256):
    """(init_state, transform) for the train step's gradient hook:
    ``transform(grads, state) -> (grads_hat, new_state)`` adds the carried
    residual, quantizes and dequantizes, and keeps the fresh residual."""

    def init_state(grads_like: Dict[str, torch.Tensor]):
        return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for n, g in grads_like.items()}

    def transform(grads, state):
        g_hat, new_state = {}, {}
        for n, g in grads.items():
            g_hat[n], new_state[n] = compress_decompress(
                g.float() + state[n], block)
        return g_hat, new_state

    return init_state, transform
