"""C3O Hub emulation (paper §III-B): job repositories carrying code +
shared runtime data + optional maintainer-supplied custom models.

A JobRepo is what a user "downloads" in workflow step (2): it bundles the
job's schema, the shared RuntimeDataStore, the candidate model list (default
models plus any maintainer custom models registered under the common model
API), and metadata for discovery on the hub.

Fits run on the device named by ``predictor_kw["device"]`` (default
"cuda"); the repo's store validates contributions on its own ``device``.
"""
from __future__ import annotations

import io
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.configurator import Configurator
from repro_torch.core.datastore import RuntimeDataStore, ValidationReport
from repro_torch.core.features import JobSchema, RuntimeData
from repro_torch.core.models.api import ModelSpec, get_model, register_model
from repro_torch.core.models.ernest import ErnestParams
from repro_torch.core.models.gbm import GBMParams
from repro_torch.core.models.linear import RidgeParams
from repro_torch.core.models.optimistic import OptimisticParams
from repro_torch.core.predictor import DEFAULT_MODELS, C3OPredictor

#: the params classes a fit sidecar may name: reading one resolves no
#: class outside this table
_PARAMS = {cls.__name__: cls
           for cls in (ErnestParams, GBMParams, RidgeParams, OptimisticParams)}


def _pack_params(params, arrays: Dict[str, np.ndarray]):
    """JSON tree of a params NamedTuple whose numpy leaves go into
    ``arrays`` under fresh keys."""
    if isinstance(params, tuple) and type(params).__name__ in _PARAMS:
        return {"kind": type(params).__name__,
                "fields": {f: _pack_params(getattr(params, f), arrays)
                           for f in params._fields}}
    if isinstance(params, tuple):
        raise TypeError(f"params class {type(params).__name__} has no "
                        "sidecar form")
    key = f"a{len(arrays)}"
    arrays[key] = np.asarray(params)
    return {"array": key}


def _unpack_params(tree, arrays):
    if "array" in tree:
        return arrays[tree["array"]]
    cls = _PARAMS[tree["kind"]]          # KeyError: not a port params class
    return cls(**{f: _unpack_params(tree["fields"][f], arrays)
                  for f in cls._fields})


@dataclass
class JobRepo:
    job: str
    algorithm: str                       # hub metadata: underlying algorithm
    schema: JobSchema
    store: RuntimeDataStore
    model_names: List[str] = field(default_factory=lambda: list(DEFAULT_MODELS))
    maintainer_machine_type: Optional[str] = None   # paper §IV-A
    # extra C3OPredictor constructor kwargs (fixed per repo, so they need
    # no cache-key slot): ``device`` ("cuda" unless asked otherwise) and
    # ``pad_rows``
    predictor_kw: Dict = field(default_factory=dict)
    # fitted-predictor cache, keyed on everything the fit depends on:
    # (machine_type, seed, datastore version, trust version, model list).
    # ``contribute`` bumps the store version only when data is accepted —
    # and the TRUST version whenever a judged contribution moved a
    # reputation — so hub traffic triggers a refit exactly when the data
    # or the reputation-derived row weights changed.
    _fit_cache: Dict[tuple, C3OPredictor] = field(default_factory=dict,
                                                  repr=False, compare=False)

    @property
    def device(self):
        """Where this repo's predictors fit and predict."""
        return self.predictor_kw.get("device", "cuda")

    def add_custom_model(self, spec: ModelSpec) -> None:
        """Maintainers ship job-specific models behind the common API
        (paper §III-C.c); they join the predictor's CV selection pool."""
        register_model(spec)
        if spec.name not in self.model_names:
            self.model_names.append(spec.name)

    def predictor_for(self, machine_type: str, seed: int = 0) -> C3OPredictor:
        # key on the spec OBJECTS, not names: re-registering a custom model
        # under an existing name must invalidate the cached fit.  The trust
        # version rides in the key because a REJECTED contribution changes
        # reputation (hence the row weights of rows already stored) without
        # bumping the data version.
        key = (machine_type, seed, self.store.version,
               self.store.trust_version,
               tuple(get_model(n) for n in self.model_names))
        pred = self._fit_cache.get(key)
        if pred is None:
            d = self.store.data.machine_view(machine_type)
            pred = C3OPredictor(model_names=tuple(self.model_names),
                                seed=seed, **self.predictor_kw) \
                .fit_data(d, row_weight=self.store.row_weights(d))
            # stale versions can never be requested again: evict them
            self._fit_cache = {
                k: v for k, v in self._fit_cache.items()
                if k[2] == self.store.version
                and k[3] == self.store.trust_version}
            self._fit_cache[key] = pred
        return pred

    # ------------------- fit-cache persistence ----------------------------
    # Saved alongside the TSV store, each entry keyed on everything the fit
    # depends on: (machine_type, seed, store fingerprint, model list).  The
    # fingerprint is the cross-process form of the in-memory store version —
    # an accepted ``contribute`` changes the data, hence the fingerprint,
    # hence invalidates every persisted fit.
    #
    # The port's sidecar is an ``.npz`` archive read with
    # ``allow_pickle=False``: a JSON header (array ``meta``) plus the numpy
    # leaves of each entry's params.  Reading one resolves no class outside
    # the port's params table (``_PARAMS``).  The JAX package's pickled
    # sidecars are NOT read (a miss, like any foreign file: unpickling one
    # would import that package); its fits carry over through
    # ``C3OPredictor.from_reference_state`` (``core/convert.py``).

    FITS_VERSION = "repro_torch-fits-1"

    @staticmethod
    def fits_path(store_path: str) -> str:
        """Conventional sidecar location for a store at ``store_path``."""
        return store_path + ".fits.npz"

    def save_fits(self, path: str) -> int:
        """Serialize the cached fitted predictors; returns the entry count.

        Only entries fitted at the CURRENT store version are saved:
        ``predictor_for`` evicts stale versions lazily (on its next miss),
        so right after an accepted ``contribute`` the cache can still hold
        fits of the pre-contribution data — stamping those with the new
        fingerprint would let a fresh process serve stale predictions."""
        entries = []
        arrays: Dict[str, np.ndarray] = {}
        for (machine_type, seed, ver, tv, specs), pred in \
                self._fit_cache.items():
            if ver != self.store.version or tv != self.store.trust_version:
                continue
            state = pred.export_state()
            try:
                params = _pack_params(state.pop("params"), arrays)
            except TypeError as e:       # a maintainer model's own params
                logging.getLogger(__name__).warning(
                    "fit for %s not saved (%s); it refits on demand",
                    machine_type, e)
                continue
            state["model_names"] = list(state["model_names"])
            entries.append({"machine_type": str(machine_type),
                            "seed": int(seed),
                            "model_names": [s.name for s in specs],
                            "trust_version": int(tv),
                            "state": state, "params": params})
        meta = json.dumps({"format": self.FITS_VERSION, "job": self.job,
                           "fingerprint": self.store.fingerprint,
                           "epoch": self.store.epoch,
                           "compactions": self.store.compactions,
                           "entries": entries}, sort_keys=True)
        buf = io.BytesIO()
        np.savez(buf, meta=np.frombuffer(meta.encode("utf-8"), np.uint8),
                 **arrays)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)            # atomic, like the store itself
        return len(entries)

    def load_fits(self, path: str) -> int:
        """Warm-start the fit cache from a sidecar; returns how many entries
        were restored.  Entries are dropped (forcing a refit on demand) when
        the store content no longer matches the saved fingerprint, the model
        list changed, the trust version moved, or the selected model is no
        longer registered.  A corrupt or unreadable sidecar (truncated
        write, foreign format, a pickle such as the JAX package's sidecar)
        is a CACHE MISS, not an error: it is logged and every predictor
        refits on demand — a damaged cache file must never take the hub
        down.  Restored predictors serve on this repo's ``device``."""
        try:
            with np.load(path, allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
            payload = json.loads(arrays.pop("meta").tobytes()
                                 .decode("utf-8"))
            entries = payload["entries"]
            fingerprint = payload.get("fingerprint")
            fmt = payload.get("format")
        except Exception as e:           # noqa: BLE001 — any damage = miss
            logging.getLogger(__name__).warning(
                "fit-cache sidecar %s unreadable (%s: %s); refitting on "
                "demand", path, type(e).__name__, e)
            return 0
        if fmt != self.FITS_VERSION or fingerprint != self.store.fingerprint:
            return 0
        # the TSV codec carries rows, not lifecycle state: a fresh process
        # re-opening a compacted store starts at epoch 0.  The sidecar is
        # written by the process that ran the compactions, so a fingerprint
        # match also vouches for its epoch counters — fast-forward.
        self.store.restore_epoch(int(payload.get("epoch", 0)),
                                 int(payload.get("compactions", 0)))
        restored = 0
        for e in entries:
            try:
                if tuple(e["model_names"]) != tuple(self.model_names):
                    continue
                # a fit made under different reputation state used
                # different row weights: restoring it would serve stale
                # weighted predictions
                if e["trust_version"] != self.store.trust_version:
                    continue
                specs = tuple(get_model(n) for n in self.model_names)
                d = self.store.data.machine_view(e["machine_type"])
                state = dict(e["state"],
                             params=_unpack_params(e["params"], arrays))
                pred = C3OPredictor.from_state(state, d.X,
                                               device=self.device)
                key = (e["machine_type"], e["seed"], self.store.version,
                       self.store.trust_version, specs)
            except KeyError:             # a model left the registry, or a
                continue                 # malformed entry: skip, refit later
            except Exception as exc:     # noqa: BLE001
                logging.getLogger(__name__).warning(
                    "fit-cache entry in %s unusable (%s: %s); skipping",
                    path, type(exc).__name__, exc)
                continue
            self._fit_cache[key] = pred
            restored += 1
        return restored

    def model_errors(self, machine_type: str, test: RuntimeData,
                     track_models: Optional[Sequence[str]] = None,
                     seed: int = 0) -> tuple:
        """Held-out (MAPE, MAE) of every tracked model on ``test`` plus the
        C3O predictor itself (paper §VI-C protocol: individual models refit
        on the shared store; the ``"c3o"`` row additionally runs LOO-CV
        model selection via ``predictor_for`` first).

        Returns ``({model: (mape, mae)}, selected_model_name)``.
        ``track_models`` may include baselines outside the repo's selection
        pool (e.g. ``"linreg"``)."""
        from repro_torch.core import engine
        specs = [get_model(n) for n in
                 (self.model_names if track_models is None else track_models)]
        tr = self.store.data.machine_view(machine_type)
        te = test.machine_view(machine_type)
        errs = engine.holdout_errors(specs, tr.X, tr.y, te.X, te.y,
                                     device=self.device)
        pred = self.predictor_for(machine_type, seed=seed)
        yhat = np.nan_to_num(pred.predict(te.X), nan=1e12, posinf=1e12,
                             neginf=-1e12)
        ae = np.abs(yhat - te.y)
        errs["c3o"] = (float(np.mean(ae / np.maximum(np.abs(te.y), 1e-9))),
                       float(np.mean(ae)))
        return errs, pred.selected

    def configurator(self, machine_type: str, prices: Dict[str, float],
                     scaleouts: Sequence[int], **kw) -> Configurator:
        return Configurator(self.predictor_for(machine_type), machine_type,
                            prices, scaleouts, **kw)

    def contribute(self, rows: RuntimeData,
                   contributor: Optional[str] = None) -> ValidationReport:
        """Workflow step (6): captured runtime data flows back, validated.
        ``contributor`` stamps the rows with the collaborator's identity
        (see ``RuntimeDataStore.contribute``)."""
        return self.store.contribute(rows, contributor=contributor)


class Hub:
    """The discovery index (paper Fig. 4, step 1).

    ``Hub``/``JobRepo`` are the in-process object layer; the canonical
    public surface is the versioned gateway API —
    ``repro_torch.api.HubGateway`` routes typed requests across every
    published repo (``tests/test_torch_gateway.py`` holds it to the JAX
    package's gateway)."""

    def __init__(self):
        self._repos: Dict[str, JobRepo] = {}
        self._transfer = None             # lazy shared TransferIndex

    def publish(self, repo: JobRepo) -> None:
        self._repos[repo.job] = repo

    def search(self, algorithm: str) -> List[JobRepo]:
        q = algorithm.lower()
        return [r for r in self._repos.values()
                if q in r.algorithm.lower() or q in r.job.lower()]

    def get(self, job: str) -> JobRepo:
        return self._repos[job]

    def jobs(self) -> List[str]:
        return sorted(self._repos)

    def transfer_index(self, policy=None):
        """The hub's shared cross-job transfer index (lazily built).

        One index per hub: its signature / pairwise-similarity caches are
        keyed on each store's (version, epoch), so sharing it across
        gateways is what makes repeated nearest-job lookups amortize.
        Passing a different ``policy`` rebuilds it."""
        from repro_torch.core.transfer import TransferIndex
        if self._transfer is None or (
                policy is not None and self._transfer.policy != policy):
            self._transfer = TransferIndex(self, policy)
        return self._transfer

    def nearest_job(self, job: str, n_features: Optional[int] = None,
                    policy=None):
        """Nearest-job lookup for cold-start transfer (None if no donor)."""
        return self.transfer_index(policy).nearest(job, n_features)

    def gateway(self, prices: Dict[str, float], scaleouts: Sequence[int],
                **kw):
        """Convenience constructor for the canonical API surface."""
        from repro_torch.api.gateway import HubGateway
        return HubGateway(self, prices, scaleouts, **kw)
