"""Carry fitted params from the JAX package over to the port.

The input is the JAX package's params pytree with numpy leaves, as its
``C3OPredictor.export_state()`` gives it: ``RidgeParams``, ``ErnestParams``,
``GBMParams`` or ``OptimisticParams`` (nested), each NamedTuple either as
itself or as a dict of its fields.  The kind is read from the field names,
so nothing of the JAX package is imported.  The output is the port's params
on ``device``, with the leading fold axis of 1 that a single fit carries.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.models.api import as_device
from repro_torch.core.models.ernest import ErnestParams
from repro_torch.core.models.gbm import GBMParams
from repro_torch.core.models.linear import RidgeParams
from repro_torch.core.models.optimistic import OptimisticParams

_KINDS = {frozenset(cls._fields): cls
          for cls in (ErnestParams, GBMParams, RidgeParams, OptimisticParams)}


def params_from_reference(params, device):
    """The port's params for a JAX-package params tree (see module doc)."""
    device = as_device(device)
    if hasattr(params, "_asdict"):
        params = params._asdict()
    if not isinstance(params, dict):
        arr = np.array(params)          # a writable copy
        dtype = torch.int32 if np.issubdtype(arr.dtype, np.integer) \
            else torch.float32
        return torch.as_tensor(arr, dtype=dtype, device=device)[None]
    cls = _KINDS.get(frozenset(params))
    if cls is None:
        raise ValueError(f"unknown params fields {sorted(params)}")
    return cls(*(params_from_reference(params[f], device)
                 for f in cls._fields))
