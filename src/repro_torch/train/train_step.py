"""The train step: loss, gradient accumulation, optimizer update.

Port of ``repro/train/train_step.py``.  ``make_train_step(cfg)`` returns
``(state, batch) -> (state, metrics)``, where the state is
{"model": the ``Model`` (its parameters require grad), "opt": the
optimizer's state keyed by parameter name, "step": an int} and is updated
in place.  Gradients accumulate over ``cfg.grad_accum`` microbatches in
``cfg.grad_accum_dtype``, each microbatch's gradient divided by the count
before it is added, as the JAX package's scan adds them; an optional
``grad_transform`` (the error-feedback compressor of
``distributed.compression``) sees the summed gradients before the update.
The sharding specs of the JAX package (``state_specs``, ``batch_specs``)
have no counterpart on one device.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.modeling.model import Model
from repro_torch.train.optimizer import get_optimizer


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [B, S, V] (any float type), labels [B, S] int (-1 = masked):
    the mean negative log-likelihood over the unmasked labels, float32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    safe = labels.clamp_min(0)
    nll = -lp.gather(-1, safe[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _chunk_nll(model: Model, x: torch.Tensor, labels: torch.Tensor):
    logits = model.lm_logits(x).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(model: Model, hidden: torch.Tensor,
                          labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Cross-entropy without the full [B, S, V] logits: the head and the
    log-sum-exp of each sequence chunk run under
    ``torch.utils.checkpoint``, so the peak logits are [B, chunk, V] and
    each chunk's are recomputed in the backward.  At gemma3's vocabulary of
    262,144 the whole logits of one microbatch (2 x 4096 tokens) would be
    8.6 GB in float32."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk != 0:                    # odd shapes: the whole logits
        return cross_entropy(model.lm_logits(hidden), labels)
    nll = cnt = 0.0
    for c0 in range(0, S, chunk):
        n, m = checkpoint(_chunk_nll, model, hidden[:, c0:c0 + chunk],
                          labels[:, c0:c0 + chunk], use_reentrant=False)
        nll, cnt = nll + n, cnt + m
    return nll / torch.clamp(cnt, min=1.0)


def loss_fn(model: Model, batch: Dict[str, torch.Tensor]):
    """(total, {"loss", "aux_loss"}): total = loss + router_aux_coef * aux,
    the metrics detached."""
    cfg = model.cfg
    labels = batch["labels"]
    hidden, aux = model.hidden_forward(batch["tokens"], mode="train")
    hidden = hidden[:, -labels.shape[1]:]
    if cfg.loss_chunk:
        loss = chunked_cross_entropy(model, hidden, labels, cfg.loss_chunk)
    else:
        loss = cross_entropy(model.lm_logits(hidden), labels)
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss.detach(), "aux_loss": aux.detach()}


def params_of(model: Model) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters keyed by name, the keys of gradients,
    optimizer state and checkpoints."""
    return dict(model.named_parameters())


def init_train_state(cfg: ModelConfig, seed: int = 0, device="cuda",
                     opt=None, gen_device="cpu") -> dict:
    """A seeded model on ``device`` (weights drawn on ``gen_device``, as
    ``Model.from_seed``), trainable, with its optimizer's fresh state."""
    model = Model.from_seed(cfg, seed, device, gen_device).trainable()
    opt = opt or get_optimizer(cfg.optimizer)
    return {"model": model, "opt": opt.init(params_of(model)), "step": 0}


def compute_grads(model: Model, batch: Dict[str, torch.Tensor]):
    """(grads keyed by name, metrics) over ``cfg.grad_accum`` microbatches:
    the parameters' type for one microbatch, float32 sums of grad / k in
    ``cfg.grad_accum_dtype`` for more; metrics averaged."""
    cfg = model.cfg
    params = params_of(model)
    names, leaves = list(params), list(params.values())
    k = cfg.grad_accum
    if k <= 1:
        total, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(total, leaves)
        return dict(zip(names, grads)), metrics
    B = batch["tokens"].shape[0]
    if B % k:
        raise ValueError(f"batch {B} does not split into {k} microbatches")
    acc_dt = getattr(torch, cfg.grad_accum_dtype)
    acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
           for p in leaves]
    sums: Dict[str, torch.Tensor] = {}
    for i in range(k):
        mb = {n: t[i * (B // k):(i + 1) * (B // k)] for n, t in batch.items()}
        total, metrics = loss_fn(model, mb)
        grads = torch.autograd.grad(total, leaves)
        for a, g in zip(acc, grads):
            a.add_((g / k).to(acc_dt))
        del grads, total
        for n, v in metrics.items():
            sums[n] = sums[n] + v if n in sums else v
    return ({n: a.float() for n, a in zip(names, acc)},
            {n: v / k for n, v in sums.items()})


def make_train_step(cfg: ModelConfig, opt=None,
                    grad_transform: Optional[Callable] = None) -> Callable:
    """``(state, batch) -> (state, metrics)``, metrics {"loss", "aux_loss",
    "grad_norm"} as float32 scalars on the device.  ``grad_transform``:
    an optional (grads) -> grads hook (e.g. compression)."""
    opt = opt or get_optimizer(cfg.optimizer)

    def train_step(state: dict, batch: Dict[str, torch.Tensor]):
        model = state["model"]
        grads, metrics = compute_grads(model, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, state["opt"], gnorm = opt.update(grads, state["opt"],
                                            params_of(model))
        metrics["grad_norm"] = gnorm
        state["step"] += 1
        return state, metrics

    return train_step


def state_tree(state: dict) -> dict:
    """The train state as a nested dict of tensors and ints, for a
    checkpoint: {"params": by name, "opt": the optimizer's state, "step"}."""
    return {"params": params_of(state["model"]), "opt": state["opt"],
            "step": state["step"]}


@torch.no_grad()
def load_state_tree(state: dict, tree: dict) -> dict:
    """Copy a tree of ``state_tree``'s structure (a restored checkpoint)
    into ``state``: tensors in place, ints assigned."""
    def copy(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                copy(dst[k], v)
            elif isinstance(v, torch.Tensor):
                dst[k].copy_(v)
            else:
                dst[k] = v
    params = params_of(state["model"])
    copy(params, tree["params"])
    copy(state["opt"], tree["opt"])
    state["step"] = tree["step"]
    return state
