"""Training driver with checkpoint/restart, a straggler watchdog and C3O
runtime capture.

Port of ``repro/launch/train.py`` on one device (there is no mesh):
  - checkpoint/restart: ``CheckpointManager.maybe_restore`` resumes
    mid-run, also after a simulated crash (``--crash-at-step``); the data
    of step N is a pure function of (seed, N), so the resumed loss curve
    continues exactly;
  - straggler watchdog: a step longer than ``--step-timeout`` times the
    median checkpoints and aborts;
  - ``--compress-grads``: the error-feedback int8 gradient hook;
  - collaborative capture (the paper's workflow step 6): the median step
    time is appended to a runtime log, one JSON line in the JAX driver's
    format plus "device" (the card's name, or "cpu") and, where a
    full-size model was cut to fit one card, the cut ("n_layers", and
    "d_ff" and "moe_d_ff" where the widths were cut);
    ``repro_torch.launch.autoconfig.records_from_runtime_log`` reads it.
On the card every attention layer runs the flash-attention kernel forward
(twice under ``remat="full"``) and its backward kernels (an MLA layer their
q/k head 96, v head 64 instances), every RWKV layer
the WKV6 kernel forward and its backward kernel, every Mamba layer the
selective-scan kernel forward and its backward kernel.

``--full`` trains the architecture's own configuration, cut where one
80 GB card cannot hold it (``train_config``): jamba-1.5-large keeps its
first 4 layers (``launch.serve.card_config``, every kind of layer) and its
FFN and expert widths cut from 24,576 to 2,048 (``TRAIN_WIDTHS``) (3.66 B parameters; the 4
layers at full width, 22.48 B, cannot hold parameters and gradients on
one card).  gemma3-1b, rwkv6-3b and minicpm3-4b train whole.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --device cpu --steps 4                         # reduced config, CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --device cpu --steps 4 --seq 32                # the chunked WKV6
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --full --steps 4 --batch 8 --seq 4096          # the card, full size
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --full --steps 4 --batch 8 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch jamba-1.5-large-398b --full --steps 4 --batch 8 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm3-4b \\
      --full --steps 4 --batch 8 --seq 4096          # 62 layers, 4.07 B
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import CUT_KEYS, get_config, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.models.api import as_device
from repro_torch.launch import autoconfig as AC
from repro_torch.launch.serve import card_config
from repro_torch.train import train_step as TS
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import make_batch
from repro_torch.train.optimizer import get_optimizer

# the widths a full-size training run on one 80 GB card cuts beside the
# serving depth cut: parameters, gradients and Adafactor's state of
# jamba-1.5-large's 4 layers at full width (22.48 B) do not fit
TRAIN_WIDTHS = {"jamba-1.5-large-398b": {"d_ff": 2048, "moe_d_ff": 2048}}


def train_config(arch: str, **kw):
    """``launch.serve.card_config(arch, **kw)`` (the depth one card
    holds), its widths cut by ``TRAIN_WIDTHS`` where one card cannot train
    them."""
    return card_config(arch, **{**TRAIN_WIDTHS.get(arch, {}), **kw})


def runtime_record(arch: str, cfg, smoke: bool, batch: int, seq: int,
                   device: torch.device, times: List[float],
                   final_loss: float) -> dict:
    """The runtime-log record of one run: the JAX driver's keys, "device",
    and where a full-size model was cut, each cut value ("n_layers",
    "d_ff", "moe_d_ff")."""
    rec = {"arch": arch, "smoke": smoke, "batch": batch, "seq": seq,
           "n_devices": 1, "model_axis": 1,
           "median_step_s": float(np.median(times[1:]) if len(times) > 1
                                  else times[0]),
           "final_loss": final_loss,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else device.type)}
    if not smoke:
        whole = get_config(arch)
        rec.update({k: getattr(cfg, k) for k in CUT_KEYS
                    if getattr(cfg, k) != getattr(whole, k)})
    return rec


def run(arch: str, steps: int, batch: int, seq: int,
        ckpt_dir: Optional[str] = None, smoke: bool = True,
        ckpt_every: int = 20, crash_at_step: int = -1,
        step_timeout: float = 10.0, seed: int = 0,
        runtime_log: Optional[str] = None, compress_grads: bool = False,
        device="cuda", n_layers: Optional[int] = None,
        history: Optional[list] = None) -> List[float]:
    """Train ``steps`` steps from the newest checkpoint in ``ckpt_dir``
    (none: no checkpoints); returns the losses of the steps run.
    ``n_layers`` cuts the depth; ``history``, a list, receives one dict
    per step (step, loss, aux_loss, grad_norm, seconds).  A full-size
    model (``train_config``) draws its weights on ``device``, a reduced
    one on the CPU."""
    overrides = {"n_layers": n_layers} if n_layers else {}
    cfg = (smoke_config(arch, **overrides) if smoke
           else train_config(arch, **overrides))
    dev = as_device(device)
    opt = get_optimizer(cfg.optimizer)

    grad_transform = None
    if compress_grads:
        from repro_torch.distributed.compression import make_ef_compressor
        init_ef, ef = make_ef_compressor()
        ef_box = {}            # the error-feedback residual, kept host-side

        def grad_transform(grads):   # noqa: F811
            if "s" not in ef_box:
                ef_box["s"] = init_ef(grads)
            g, ef_box["s"] = ef(grads, ef_box["s"])
            return g

    step_fn = TS.make_train_step(cfg, opt=opt, grad_transform=grad_transform)
    state = TS.init_train_state(cfg, seed, dev, opt=opt,
                                gen_device="cpu" if smoke else dev)
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    start = 0
    if mgr is not None:
        tree, start = mgr.maybe_restore(TS.state_tree(state))
        if start:
            TS.load_state_tree(state, tree)

    times, losses = [], []
    for step in range(start, steps):
        t0 = time.perf_counter()
        data = {n: t.to(dev) for n, t in
                make_batch(cfg, batch, seq, step, seed=seed).items()}
        state, metrics = step_fn(state, data)
        loss = float(metrics["loss"])          # waits for the device
        dt = time.perf_counter() - t0
        times.append(dt)
        losses.append(loss)
        if history is not None:
            history.append({"step": step, "loss": loss,
                            "aux_loss": float(metrics["aux_loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "seconds": dt})
        # straggler watchdog: a wedged step must not hang the job
        if len(times) > 5 and dt > step_timeout * np.median(times[1:]):
            if mgr is not None:
                mgr.save(step + 1, TS.state_tree(state))
            raise SystemExit(f"straggler watchdog: step {step} took "
                             f"{dt:.1f}s (median {np.median(times):.2f}s)"
                             " — checkpointed and aborting for restart")
        if mgr is not None and ((step + 1) % ckpt_every == 0
                                or step == steps - 1):
            mgr.save(step + 1, TS.state_tree(state))
        if crash_at_step == step:
            raise SystemExit(f"simulated crash at step {step}")
    final_loss = losses[-1] if losses else float("nan")

    if runtime_log and times:
        os.makedirs(os.path.dirname(runtime_log) or ".", exist_ok=True)
        with open(runtime_log, "a") as f:
            f.write(json.dumps(runtime_record(arch, cfg, smoke, batch, seq,
                                              dev, times, final_loss))
                    + "\n")
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--crash-at-step", type=int, default=-1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--runtime-log", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    history: list = []
    losses = run(args.arch, args.steps, args.batch, args.seq, args.ckpt_dir,
                 smoke=args.smoke, ckpt_every=args.ckpt_every,
                 crash_at_step=args.crash_at_step,
                 compress_grads=args.compress_grads,
                 runtime_log=args.runtime_log, device=args.device,
                 n_layers=args.n_layers, history=history)
    print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f} "
          f"({len(losses)} steps)")
    if not args.smoke and history:
        secs = [h["seconds"] for h in history]
        median = float(np.median(secs[1:] if len(secs) > 1 else secs))
        cfg = train_config(args.arch, **({"n_layers": args.n_layers}
                                         if args.n_layers else {}))
        job = ShapeConfig("train_cli", args.seq, args.batch, "train")
        predicted = AC.predicted_step_time(
            cfg, job, AC.GPU_FAMILIES["h100-sxm"], 1)
        print(f"median step {median:.4f} s (first step excluded); the "
              f"analytic model's H100 step {predicted:.4f} s")


if __name__ == "__main__":
    main()
