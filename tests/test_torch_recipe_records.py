"""The committed records of the port's runs of the JAX package's recipes on
the GPU (``docs/benchmarks/torch_h100_<run>_*``, summarized by
``docs/benchmarks/torch_h100_recipes_report.py``): each leg's ``config:``
line is its JAX run's header field for field but for the fields the run
declares, each eval row records the run's steps at the registered solver
iterations, and the pixel r4 bands are what ``chip_smoke.record_band``
gives.  Reads committed files only."""

from __future__ import annotations

import importlib.util
import json

import pytest
import torch

from torch_port_helpers import ROOT

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_h100_recipes_report", ROOT / "docs" / "benchmarks" / "torch_h100_recipes_report.py")
report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(report)


@pytest.mark.parametrize("run", list(report.RUNS))
def test_config_lines_equal_jax_headers(run):
    """Every leg's config line against its JAX header: the fields that
    differ are exactly the run's declared ones (a field the older header
    lacks counts only when it is not None)."""
    declared = set(report.RUNS[run].declared)
    diffs = report.config_diff(run)
    assert len(diffs) == len(report.RUNS[run].jax_legs)
    for leg, diff in enumerate(diffs):
        assert set(diff) == declared, (leg + 1, diff)


@pytest.mark.parametrize("run", list(report.RUNS))
def test_eval_rows_record_the_run(run):
    """The last logged update and each eval row's ``trained_timesteps`` are
    the run's steps; every eval ran 128 episodes of the recipe's env and
    policy at the registered 180/60."""
    spec = report.RUNS[run]
    leg_path, row_path, _times = report.paths(run)
    last = report.config(leg_path(len(spec.jax_legs)))
    assert report.updates(leg_path(len(spec.jax_legs)))[-1]["timesteps"] == spec.steps
    for k in range(3):
        row = json.loads(row_path(k).read_text())
        assert row["trained_timesteps"] == spec.steps
        assert row["eval_solver_iters"] == [180, 60]
        assert len(row["returns"]) == 128
        assert repr(row["env_id"]) == last["env_id"]
        assert repr(row.get("policy", "mlp")) == last["policy"]


@pytest.mark.parametrize("n, band", [(384, (-12_105.3, -9_483.8)), (768, (-11_966.9, -9_622.2))],
                         ids=["one_run", "two_runs"])
def test_cnn_r4_bands(n, band):
    """The pixel r4 records (256 JAX episodes, pooled mean -10,794.5, sd
    5,414.8) give the bands held for one run and for two runs pooled."""
    mean, sd, n_jax, got = report.record_band(report.RUNS["cnn4_s17"].records, n)
    assert (round(mean, 1), round(sd, 1), n_jax) == (-10_794.5, 5_414.8, 256)
    assert tuple(round(x, 1) for x in got) == band


@pytest.mark.parametrize("group, means, within, inside", [
    ("hv2", (1_528.1, 2_781.8, 2_777.4, 3_462.0), True, True),
    ("cnn4", (-10_558.8, -9_594.0), True, True),
])
def test_seed_pools(group, means, within, inside):
    """A recipe's runs at several training seeds: their pooled means, the
    seed-spread rule (the JAX mean inside M +- 3 s / 2, s the sample
    standard deviation of the runs' means) and all their episodes against
    the band for that many, as the records say."""
    g = report.seed_pool(group)
    assert tuple(round(m, 1) for m in g["means"]) == means
    assert g["M"] == pytest.approx(sum(means) / len(means), abs=0.1)
    assert (g["within"], g["inside"]) == (within, inside)
