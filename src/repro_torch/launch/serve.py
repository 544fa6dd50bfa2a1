"""Batched serving driver: prefill a batch of prompts, then decode greedily.

Port of ``repro/launch/serve.py`` for the dense attention families,
multi-head latent attention (minicpm3-4b), RWKV6 and the Mamba +
attention + MoE hybrid.  It serves a reduced (``--smoke``, the default)
or full (``--full``) architecture with seeded weights, reports prefill
time and the median per-token decode time, and appends them to the C3O
runtime log that the configurator predicts from.  In an attention layer
prefill runs the flash-attention kernel and each decode step the
flash-decode kernels; in an MLA layer prefill runs the flash-attention
kernel at q/k head 96 and v head 64 and each decode step the MLA decode
kernel over the latent caches; in an RWKV6 layer prefill runs the WKV6
kernel, in a Mamba layer the selective-scan kernel, and their state caches
do not depend on the cache length.  A full-width model draws its
weights on the run's device (a reduced one on the CPU, as the tests do).

Usage (on the card, full width):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --full \\
      --batch 8 --prompt-len 2048 --max-new 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --full \\
      --batch 8 --prompt-len 2048 --max-new 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \\
      --full --batch 8 --prompt-len 2048 --max-new 64
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch jamba-1.5-large-398b --full --batch 8 --prompt-len 2048 \\
      --max-new 64
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.models.api import as_device
from repro_torch.modeling.model import Model
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step


# Depth of a full-width model on one 80 GB card, where the whole model does
# not fit: jamba-1.5-large's 72 layers are 398 B parameters, and its first
# 4 (mamba + FFN, mamba + MoE, mamba + FFN, attention + MoE) hold every
# kind of layer in 22.5 B parameters, 45 GB in bf16.
CARD_DEPTH = {"jamba-1.5-large-398b": 4}


def card_config(arch: str, **kw):
    """``get_config(arch, **kw)`` at full width, its depth cut to
    ``CARD_DEPTH`` where the whole model does not fit one card."""
    cut = {"n_layers": CARD_DEPTH[arch]} if arch in CARD_DEPTH else {}
    return get_config(arch, **{**cut, **kw})


def runtime_record(arch: str, cfg, smoke: bool, batch: int, prompt_len: int,
                   prefill_s: float, decode_median_s: float) -> dict:
    """The runtime-log record of one run: the JAX driver's keys, and
    ``n_layers`` where a full-width model's depth was cut, so that a cut
    run's times never pass for the whole architecture's."""
    rec = {"arch": arch, "mode": "serve", "batch": batch,
           "prompt_len": prompt_len, "prefill_s": prefill_s,
           "decode_median_s": decode_median_s}
    if not smoke and cfg.n_layers != get_config(arch).n_layers:
        rec["n_layers"] = cfg.n_layers
    return rec


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def run(arch: str, batch: int, prompt_len: int, max_new: int,
        smoke: bool = True, kv_dtype: str = "",
        runtime_log: Optional[str] = None, seed: int = 0,
        device="cuda") -> torch.Tensor:
    """Serve one batch; returns the generated tokens [batch, max_new].
    Times are host clocks around work that ends in a device
    synchronisation; a full-width model's weights are drawn on ``device``
    from a generator seeded with ``seed``, and its depth is cut to
    ``CARD_DEPTH`` where the whole model does not fit one card (the
    runtime-log record then gives the depth served)."""
    cfg = (smoke_config(arch, kv_cache_dtype=kv_dtype) if smoke
           else card_config(arch, kv_cache_dtype=kv_dtype))
    dev = as_device(device)
    t0 = time.perf_counter()
    model = Model.from_seed(cfg, seed, dev,
                            gen_device="cpu" if smoke else dev)
    _sync(dev)
    t_init = time.perf_counter() - t0
    max_seq = prompt_len + max_new + 8
    cache = model.init_cache(batch, max_seq)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    gen = torch.Generator().manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen).to(dev)
    _sync(dev)

    t0 = time.perf_counter()
    logits, cache = prefill(prompts, cache)
    tok = logits.argmax(-1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    outs, lat = [tok], []
    for pos in range(prompt_len, prompt_len + max_new - 1):
        t1 = time.perf_counter()
        logits, cache = decode(tok, pos, cache)
        tok = logits.argmax(-1)
        _sync(dev)
        lat.append(time.perf_counter() - t1)
        outs.append(tok)
    med = float(np.median(lat)) if lat else 0.0
    print(f"{arch} ({cfg.n_layers} layers): init {t_init:.2f}s; "
          f"prefill({prompt_len} toks x {batch}) "
          f"{t_prefill*1e3:.1f}ms; decode median {med*1e3:.2f}ms/token "
          f"(kv={cfg.kv_cache_dtype or cfg.dtype})")
    if runtime_log:
        os.makedirs(os.path.dirname(runtime_log) or ".", exist_ok=True)
        with open(runtime_log, "a") as f:
            f.write(json.dumps(runtime_record(
                arch, cfg, smoke, batch, prompt_len, t_prefill, med)) + "\n")
    return torch.stack(outs, dim=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--kv-dtype", default="")
    ap.add_argument("--runtime-log", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.arch, args.batch, args.prompt_len, args.max_new,
        smoke=args.smoke, kv_dtype=args.kv_dtype,
        runtime_log=args.runtime_log, device=args.device)


if __name__ == "__main__":
    main()
