"""C3O-for-GPU: the paper's technique applied to the framework's own domain.

Port of ``repro/launch/autoconfig.py`` ("C3O-for-TPU").  "Machine types"
are accelerator families, "scale-out" is the chip count, and a "job" is an
(arch x input-shape) workload.  Shared runtime records, measured step
times from real runs (``launch/train.py --runtime-log``, read by
``records_from_runtime_log``) beside roofline estimates from the analytic
model (``simulate_runtime_records``), feed the same C3O predictor and
configurator stack as the paper's loop: LOO-CV model selection, the
Gaussian-confidence scale-out choice, cost menus.

The table of families is a parameter of every function.  The default,
``GPU_FAMILIES``, holds NVIDIA cards, each number with its public source;
the JAX package's TPU table (``SLICES``) gives the reference's choices when
it is passed instead.  The mesh rule for a chip count is the reference's.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs import CUT_KEYS, get_config, smoke_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core.configurator import Configurator
from repro_torch.core.datastore import RuntimeDataStore
from repro_torch.core.features import JobSchema, RuntimeData
from repro_torch.core.predictor import C3OPredictor
from repro_torch.launch.analytic import analytic_cost


@dataclass(frozen=True)
class AcceleratorFamily:
    name: str
    peak_flops: float        # dense bf16 FLOP/s a chip
    hbm_bw: float            # device-memory bytes/s a chip
    ici_bw: float            # chip-to-chip bytes/s a chip, one direction
    hbm_gb: float            # device memory a chip, in GiB (the check's unit)
    price_per_chip_h: float  # $ a chip-hour, on demand
    device_names: Tuple[str, ...] = ()   # substrings of torch's device name


GPU_FAMILIES: Dict[str, AcceleratorFamily] = {
    # NVIDIA H100 Tensor Core GPU data sheet (2023), SXM5 part: 989 TFLOP/s
    # bf16 dense (1,979 with sparsity), 3.35 TB/s HBM3, 80 GB, NVLink 900
    # GB/s (both directions, 450 GB/s each way).  Price: AWS EC2 On-Demand
    # pricing, US East (N. Virginia), Linux, as listed in 2024: p5.48xlarge
    # (8 x H100 SXM 80GB) $98.32 an hour, $12.29 a GPU-hour.
    "h100-sxm": AcceleratorFamily(
        "h100-sxm", 989e12, 3.35e12, 450e9, 80e9 / 2 ** 30, 98.32 / 8,
        ("H100 80GB HBM3", "H100 SXM")),
    # NVIDIA A100 Tensor Core GPU data sheet (2021), SXM 80GB part: 312
    # TFLOP/s bf16 dense, 2,039 GB/s HBM2e, 80 GB, NVLink 600 GB/s (both
    # directions).  Price: AWS EC2 On-Demand pricing, US East (N.
    # Virginia), Linux, as listed in 2024: p4de.24xlarge (8 x A100 80GB)
    # $40.96576 an hour, $5.12 a GPU-hour.
    "a100-sxm-80gb": AcceleratorFamily(
        "a100-sxm-80gb", 312e12, 2.039e12, 300e9, 80e9 / 2 ** 30,
        40.96576 / 8, ("A100-SXM4-80GB", "A100 80GB")),
}
DEFAULT_FAMILY = "h100-sxm"
DEFAULT_CHIPS = (8, 16, 32, 64)

# the reference's tpu_step schema, renamed for the port: the same features
GPU_SCHEMA = JobSchema(
    "gpu_step", ("tokens_per_step", "params_b", "active_params_b"),
    base_features=("scale_out", "seq_len"))


def _mesh_for(chips: int) -> Dict[str, int]:
    model = 16 if chips >= 256 else max(chips // 16, 1)
    return {"data": chips // model, "model": model}


def _shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def predicted_step_time(cfg: ModelConfig, shape: ShapeConfig,
                        fam: AcceleratorFamily, chips: int) -> float:
    """Roofline step time on a family: the largest of the analytic model's
    operations over the peak, device-memory bytes over its rate and
    collective bytes over the chip-to-chip rate (the 'simulator' that
    stands in for runs at scale)."""
    ana = analytic_cost(cfg, shape, _mesh_for(chips))
    return max(ana.flops / fam.peak_flops,
               ana.hbm_bytes / fam.hbm_bw,
               ana.coll_bytes / fam.ici_bw)


def _row(chips: int, shape: ShapeConfig, batch: int, cfg: ModelConfig):
    counts = cfg.param_counts()
    return [chips, shape.seq_len, batch * shape.seq_len,
            counts["total"] / 1e9, counts["active"] / 1e9]


def simulate_runtime_records(arch: str, shape_name: Union[str, ShapeConfig],
                             family: str = DEFAULT_FAMILY,
                             chip_counts: Sequence[int] = DEFAULT_CHIPS,
                             contexts: int = 4, reps: int = 3,
                             noise: float = 0.06, seed: int = 0,
                             families: Optional[Dict] = None,
                             schema: JobSchema = GPU_SCHEMA) -> RuntimeData:
    """Shared runtime data as many users' training runs would give it: the
    same arch at several chip counts, with per-user context (the batch
    halved per context, at least 32) and lognormal measurement noise;
    medians of ``reps`` runs."""
    families = families or GPU_FAMILIES
    rng = np.random.default_rng(seed)
    shape0 = _shape(shape_name)
    cfg = get_config(arch)
    rows, ys = [], []
    fam = families[family]
    for ctx in range(contexts):
        bs = max(shape0.global_batch >> ctx, 32)
        shape = dataclasses.replace(shape0, global_batch=bs)
        for chips in chip_counts:
            t = predicted_step_time(cfg, shape, fam, chips)
            runs = t * rng.lognormal(0.0, noise, reps)
            rows.append(_row(chips, shape, bs, cfg))
            ys.append(float(np.median(runs)))
    n = len(ys)
    return RuntimeData(schema, np.asarray([family] * n),
                       np.asarray(rows, np.float64), np.asarray(ys))


def family_of(device_name: str, families: Optional[Dict] = None) -> str:
    """The family whose ``device_names`` occur in ``device_name`` (as
    ``torch.cuda.get_device_name`` gives it), else the name itself."""
    for fam in (families or GPU_FAMILIES).values():
        if any(s in device_name for s in fam.device_names):
            return fam.name
    return device_name


def records_from_runtime_log(path: str, families: Optional[Dict] = None,
                             schema: JobSchema = GPU_SCHEMA) -> RuntimeData:
    """The training lines of a runtime log (``launch/train.py``'s records;
    serving lines are skipped) as rows of ``schema``: scale-out the
    record's devices, its sequence length, tokens a step, the parameter
    counts (billions) of the configuration it ran, with its depth and
    widths cut where the record says so (``configs.CUT_KEYS``:
    "n_layers", "d_ff", "moe_d_ff"); the runtime its median step in seconds;
    the machine type its device's family."""
    machines, rows, ys = [], [], []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            if "median_step_s" not in rec:
                continue
            cut = {k: rec[k] for k in CUT_KEYS if k in rec}
            cfg = (smoke_config(rec["arch"], **cut) if rec["smoke"]
                   else get_config(rec["arch"], **cut))
            shape = ShapeConfig("runtime_log", rec["seq"], rec["batch"],
                                "train")
            rows.append(_row(rec["n_devices"], shape, rec["batch"], cfg))
            ys.append(float(rec["median_step_s"]))
            machines.append(family_of(rec.get("device", ""), families))
    return RuntimeData(schema, np.asarray(machines),
                       np.asarray(rows, np.float64).reshape(-1, 5),
                       np.asarray(ys, np.float64))


def autoconfigure(arch: str, shape_name: Union[str, ShapeConfig], *,
                  step_budget_s: Optional[float] = None,
                  family: str = DEFAULT_FAMILY,
                  chip_counts: Sequence[int] = DEFAULT_CHIPS,
                  store: Optional[RuntimeDataStore] = None,
                  confidence: float = 0.95, seed: int = 0,
                  families: Optional[Dict] = None, device="cuda"):
    """Pick (family, chips) for a workload from shared runtime records:
    the store's rows of ``family``, else simulated ones.  Returns
    (ClusterChoice, predictor), the paper's workflow steps 2-5 with
    accelerator families in place of EC2 machine types.  The predictor
    fits on ``device``."""
    families = families or GPU_FAMILIES
    data = (store.data if store is not None
            else simulate_runtime_records(arch, shape_name, family=family,
                                          chip_counts=chip_counts, seed=seed,
                                          families=families))
    d = data.filter_machine(family)
    pred = C3OPredictor(seed=seed, device=device).fit(d.X, d.y)
    shape = _shape(shape_name)
    cfg = get_config(arch)
    counts = cfg.param_counts()
    ctx_row = np.asarray(_row(0, shape, shape.global_batch, cfg)[1:])
    fam = families[family]

    def bottleneck(ctx, chips):
        # weights + optimizer must fit the family's device memory
        opt_b = 8.0 if cfg.optimizer == "adamw" else 0.5
        need = counts["total"] * (2.0 + opt_b) / chips
        return need > 0.9 * fam.hbm_gb * 2 ** 30

    conf = Configurator(pred, family,
                        {f.name: f.price_per_chip_h for f in families.values()},
                        chip_counts, confidence=confidence,
                        bottleneck_fn=bottleneck)
    choice = conf.choose_scaleout(ctx_row, t_max=step_budget_s)
    return choice, pred
