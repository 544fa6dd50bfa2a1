"""Fault-tolerant checkpoints of a train state.

Port of ``repro/train/checkpoint.py`` on one device.  The format is the
JAX package's: ``step_<N>/`` holds one ``.npz`` of the leaves and a JSON
manifest (step, leaf names, shapes, dtypes, complete), written to
``<dir>.tmp`` and published with ``os.replace``.  Leaves are keyed by
their path in the state's nested dicts ("params/embed",
"opt/m/layers.0.attn.wq", "step"), not by a JAX treedef.  bfloat16, which
numpy has no type for, is stored as its uint16 bits with "bfloat16" in the
manifest; Python ints as int64 scalars.  ``CheckpointManager`` keeps the
newest K checkpoints, ignores torn writes (no manifest) and falls back to
the previous checkpoint when the newest cannot be read.  Restoring casts
each leaf to the type of the target's leaf and puts it on the target's
device; there is no mesh to re-shard onto.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"
_DATA = "shards.npz"


def _flatten(tree, prefix="") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: Dict[str, Any]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    if isinstance(x, (bool, int)):
        return np.asarray(int(x), np.int64), "int"
    a = np.asarray(x)
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Atomic write of a nested dict of tensors, arrays and ints."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    names = list(flat)
    leaves = [_to_numpy(flat[n]) for n in names]
    np.savez(os.path.join(tmp, _DATA),
             **{f"leaf_{i}": a for i, (a, _) in enumerate(leaves)})
    manifest = {"step": int(step), "n_leaves": len(names), "names": names,
                "shapes": [list(a.shape) for a, _ in leaves],
                "dtypes": [d for _, d in leaves], "complete": True}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)                     # atomic publish
    return path


def restore_checkpoint(path: str, like_tree):
    """(tree, step): the checkpoint's leaves in the structure of
    ``like_tree``, each cast to its leaf's type and placed on its leaf's
    device (ints stay ints)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if not manifest.get("complete"):
        raise IOError(f"incomplete checkpoint at {path}")
    like = _flatten(like_tree)
    index = {n: i for i, n in enumerate(manifest["names"])}
    if set(like) != set(index):
        raise KeyError(f"leaves differ: missing {sorted(set(like) - set(index))}"
                       f", extra {sorted(set(index) - set(like))}")
    out = {}
    with np.load(os.path.join(path, _DATA)) as data:
        for name, ref in like.items():
            i = index[name]
            arr, dtype = data[f"leaf_{i}"], manifest["dtypes"][i]
            if list(arr.shape) != manifest["shapes"][i]:
                raise IOError(f"{name}: stored shape {list(arr.shape)}, "
                              f"manifest {manifest['shapes'][i]}")
            if isinstance(ref, torch.Tensor):
                out[name] = _from_numpy(arr, dtype).to(device=ref.device,
                                                       dtype=ref.dtype)
            elif isinstance(ref, (bool, int)):
                out[name] = int(arr)
            else:
                out[name] = np.asarray(arr).astype(np.asarray(ref).dtype)
    return _unflatten(out), manifest["step"]


class CheckpointManager:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)

    def _steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if not m:
                continue
            if os.path.exists(os.path.join(self.dir, name, _MANIFEST)):
                out.append(int(m.group(1)))     # torn writes lack manifest
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self._steps()
        return s[-1] if s else None

    def save(self, step: int, tree) -> str:
        path = save_checkpoint(self.dir, step, tree)
        for old in self._steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{old:08d}"),
                          ignore_errors=True)
        return path

    def maybe_restore(self, like_tree):
        """(tree, step) from the newest valid checkpoint, or (like_tree,
        0)."""
        step = self.latest_step()
        if step is None:
            return like_tree, 0
        path = os.path.join(self.dir, f"step_{step:08d}")
        try:
            return restore_checkpoint(path, like_tree)
        except Exception:
            # torn/corrupt newest checkpoint: fall back to the previous one
            steps = self._steps()[:-1]
            if not steps:
                return like_tree, 0
            path = os.path.join(self.dir, f"step_{steps[-1]:08d}")
            return restore_checkpoint(path, like_tree)
