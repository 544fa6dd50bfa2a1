"""Collaborative evaluation replay plane (paper §VI, Fig. 5/6 analogue).

Reproduces the paper's headline empirical protocol: many users with
heterogeneous execution contexts contribute runtime data to the shared
collaborative store over time, and prediction error for a *held-out* user
is measured as a function of store size — leave-one-user-out over the
multi-user dataset emulated by ``repro_torch.workloads.spark_emul``.

``repro_torch.eval.dataset``      multi-user dataset assembly + contribution
                                  chunking
``repro_torch.eval.replay``       the deterministic replay harness and its
                                  CLI (``python -m repro_torch.eval.replay``)
``repro_torch.eval.adversarial``  the replay under poisoned contributors,
                                  reputation weighting on vs off
"""
from repro_torch.eval.dataset import (MultiUserData, build_multi_user,
                                      contribution_chunks)

__all__ = ["MultiUserData", "build_multi_user", "contribution_chunks"]

# NOTE: repro_torch.eval.replay is intentionally NOT imported here — it is
# the ``python -m repro_torch.eval.replay`` entry point, and importing it
# from the package __init__ would double-execute the module under runpy.
