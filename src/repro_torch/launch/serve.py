"""Batched serving driver: prefill a batch of prompts, then decode greedily.

Port of ``repro/launch/serve.py`` for the dense attention families and
RWKV6.  It serves a reduced (``--smoke``, the default) or full
(``--full``) architecture with seeded weights, reports prefill time and
the median per-token decode time, and appends them to the C3O runtime log
that the configurator predicts from.  In an attention model prefill runs
the flash-attention kernel in every layer and each decode step the
flash-decode kernels; in rwkv6-3b prefill runs the WKV6 kernel in every
layer, and its state caches do not depend on the cache length.

Usage (on the card, full width):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --full \\
      --batch 8 --prompt-len 2048 --max-new 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --full \\
      --batch 8 --prompt-len 2048 --max-new 64
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
from repro_torch.modeling.model import Model
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step


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
    synchronisation."""
    cfg = (smoke_config(arch, kv_cache_dtype=kv_dtype) if smoke
           else get_config(arch, kv_cache_dtype=kv_dtype))
    model = Model.from_seed(cfg, seed, device)
    dev = model.device
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
    print(f"{arch}: prefill({prompt_len} toks x {batch}) "
          f"{t_prefill*1e3:.1f}ms; decode median {med*1e3:.2f}ms/token "
          f"(kv={cfg.kv_cache_dtype or cfg.dtype})")
    if runtime_log:
        os.makedirs(os.path.dirname(runtime_log) or ".", exist_ok=True)
        with open(runtime_log, "a") as f:
            f.write(json.dumps({"arch": arch, "mode": "serve",
                                "batch": batch, "prompt_len": prompt_len,
                                "prefill_s": t_prefill,
                                "decode_median_s": med}) + "\n")
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
