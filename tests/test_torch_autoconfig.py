"""The port's launch planning against the JAX package on the CPU: the
analytic cost model on every registered config x shape x mesh, the
roofline step time and the simulated records on the reference's TPU table,
``autoconfigure``'s choice with that table, and the port's own pieces: the
GPU table, and runtime-log lines of ``launch/train.py`` read back as
``gpu_step`` rows that can sit in a store beside simulated ones.

The analytic model is the same Python arithmetic on both sides, so its
numbers are compared for equality; the choice's predicted runtime comes
from predictors fitted by two frameworks, compared at 1e-4 relative.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES, get_config as jget, list_archs
from repro.launch import analytic as JAN
from repro.launch import autoconfig as JA
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.datastore import RuntimeDataStore
from repro_torch.launch import analytic as PAN
from repro_torch.launch import autoconfig as PA
from repro_torch.launch import train as port_train

MESHES = [{"data": 1, "model": 1}, {"data": 16, "model": 16},
          {"pod": 2, "data": 8, "model": 4}]
REF_FAMILIES = {k: PA.AcceleratorFamily(
    v.name, v.peak_flops, v.hbm_bw, v.ici_bw, v.hbm_gb, v.price_per_chip_h)
    for k, v in JA.SLICES.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_cost_equals_the_reference(arch):
    for name, shape in JSHAPES.items():
        for mesh in MESHES:
            want = JAN.analytic_cost(jget(arch), shape, mesh)
            got = PAN.analytic_cost(get_config(arch), SHAPES[name], mesh)
            assert (got.flops, got.hbm_bytes, got.coll) == \
                (want.flops, want.hbm_bytes, want.coll), (name, mesh)


@pytest.mark.parametrize("arch,shape", [("gemma3-1b", "train_4k"),
                                        ("deepseek-7b", "prefill_32k"),
                                        ("jamba-1.5-large-398b", "train_4k")])
def test_step_time_and_records_equal_the_reference(arch, shape):
    for fam in JA.SLICES:
        for chips in (1, 64, 512):
            assert PA.predicted_step_time(
                get_config(arch), SHAPES[shape], REF_FAMILIES[fam], chips) \
                == JA.predicted_step_time(jget(arch), JSHAPES[shape],
                                          JA.SLICES[fam], chips)
    want = JA.simulate_runtime_records(arch, shape, slice_name="v4", seed=3)
    got = PA.simulate_runtime_records(arch, shape, family="v4", seed=3,
                                      chip_counts=(64, 128, 256, 512),
                                      families=REF_FAMILIES,
                                      schema=JA.TPU_SCHEMA)
    np.testing.assert_array_equal(got.X, want.X)
    np.testing.assert_array_equal(got.y, want.y)
    assert list(got.machine_type) == list(want.machine_type)


def test_autoconfigure_with_the_reference_table_gives_its_choice():
    want, wpred = JA.autoconfigure("gemma3-1b", "train_4k")
    got, gpred = PA.autoconfigure("gemma3-1b", "train_4k", family="v5e",
                                  chip_counts=(64, 128, 256, 512),
                                  families=REF_FAMILIES, device="cpu")
    assert gpred.selected == wpred.selected
    assert (got.machine_type, got.scale_out, got.bottleneck) == \
        (want.machine_type, want.scale_out, want.bottleneck)
    for f in ("predicted_runtime_s", "runtime_bound_s", "cost_usd"):
        assert abs(getattr(got, f) - getattr(want, f)) <= \
            1e-4 * abs(getattr(want, f)), f


def test_gpu_table():
    h100 = PA.GPU_FAMILIES["h100-sxm"]
    assert (h100.peak_flops, h100.hbm_bw) == (989e12, 3.35e12)
    assert h100.hbm_gb * 2 ** 30 == 80e9
    for fam in PA.GPU_FAMILIES.values():
        assert fam.price_per_chip_h > 0 and fam.device_names
    assert PA.family_of("NVIDIA H100 80GB HBM3") == "h100-sxm"
    assert PA.family_of("NVIDIA A100-SXM4-80GB") == "a100-sxm-80gb"
    assert PA.family_of("cpu") == "cpu"
    choice, _ = PA.autoconfigure("gemma3-1b", "train_4k", device="cpu")
    assert choice.machine_type == "h100-sxm"
    assert choice.scale_out in PA.DEFAULT_CHIPS


def test_runtime_log_round_trips_into_a_store(tmp_path):
    """Lines of ``launch/train.py`` (a CPU run, a card run's line with its
    depth cut, and a serving line, which is skipped) become ``gpu_step``
    rows that join simulated H100 rows in a store and an autoconfigure."""
    log = tmp_path / "rt.jsonl"
    port_train.run("gemma3-1b", 2, 2, 16, device="cpu", runtime_log=str(log))
    card = port_train.runtime_record(
        "gemma3-1b", get_config("gemma3-1b", n_layers=2), False, 8, 4096,
        torch.device("cpu"), [2.0, 1.5, 1.7], 9.0)
    card["device"] = "NVIDIA H100 80GB HBM3"
    with open(log, "a") as f:
        f.write(json.dumps(card) + "\n")
        f.write(json.dumps({"arch": "gemma3-1b", "mode": "serve",
                            "batch": 8, "prompt_len": 2048,
                            "prefill_s": 0.07, "decode_median_s": 0.03})
                + "\n")
    recs = [json.loads(ln) for ln in open(log)][:2]
    data = PA.records_from_runtime_log(str(log))
    assert data.schema == PA.GPU_SCHEMA and len(data.y) == 2
    assert list(data.machine_type) == ["cpu", "h100-sxm"]
    np.testing.assert_array_equal(data.y, [r["median_step_s"] for r in recs])
    cut = get_config("gemma3-1b", n_layers=2).param_counts()
    np.testing.assert_array_equal(data.X[1], [
        1, 4096, 8 * 4096, cut["total"] / 1e9, cut["active"] / 1e9])
    assert data.X[0][:3].tolist() == [1, 16, 32]
    sim = PA.simulate_runtime_records("gemma3-1b", "train_4k")
    store = RuntimeDataStore(sim.concat(data), device="cpu")
    choice, pred = PA.autoconfigure("gemma3-1b", "train_4k", store=store,
                                    device="cpu")
    assert choice.machine_type == "h100-sxm" and pred.selected
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=8)
    assert PA.predicted_step_time(get_config("gemma3-1b"), shape,
                                  PA.GPU_FAMILIES["h100-sxm"], 1) > 0
