"""The committed records of the port's runs of the JAX package's recipes on
the GPU (``docs/benchmarks/torch_h100_<run>_*``, summarized by
``docs/benchmarks/torch_h100_recipes_report.py``): each leg's ``config:``
line is its JAX run's header field for field but for the fields the run
declares, each eval row records the run's steps at the registered solver
iterations, each update's step count is the JAX run's modulo 2^32, and
the pixel r4 and Heavy-v0 bands are what ``chip_smoke.record_band`` gives.
Reads committed files only."""

from __future__ import annotations

import importlib.util
import json

import numpy as np
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
    row_path = report.paths(run)[1]
    last = report.config(report.leg_log(run, len(spec.jax_legs)))
    assert report.updates(report.leg_log(run, len(spec.jax_legs)))[-1]["timesteps"] == spec.steps
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
    ("hv0h2", (-22_502.9, -22_841.4, -22_402.0), False, True),
    ("hv0c_curB", (-47_907.5, -37_060.3, -36_125.4), True, True),
    ("hv0c_x2", (-40_868.8, -31_509.2, -26_638.0), True, True),
    ("hv0c_x3", (-30_592.5, -26_524.6, -24_517.2), True, True),
    ("hv0c_x4", (-20_738.5, -17_342.8, -16_618.6), True, True),
    ("hv0c_h2", (-20_125.5, -22_516.9, -18_377.2), True, True),
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


@pytest.mark.parametrize("run", list(report.RUNS))
def test_step_counts_follow_jax(run):
    """Each leg's logged step counts are the JAX run's at the same updates,
    modulo 2^32 (the JAX counter is int32, the port's int64): a warm start
    and a resume carry the count across."""
    for k, jax_leg in enumerate(report.RUNS[run].jax_legs):
        port = report.updates(report.leg_log(run, k + 1))
        ref = report.updates(report.RECORDS / jax_leg)[:len(port)]
        assert len(ref) == len(port), (k + 1, len(ref), len(port))
        assert [u["timesteps"] % 2**32 for u in port] == [u["timesteps"] % 2**32 for u in ref]


@pytest.mark.parametrize("records, n, stats, band", [
    (report.HV0H2[0], 384, (-20_823.9, 15_496.5, 384), (-24_179.0, -17_468.8)),
    (report.HV0H2[0], 1_152, (-20_823.9, 15_496.5, 384), (-23_563.3, -18_084.5)),
    (report.RUNS["hv0h3"].records, 384, (-31_227.3, 20_259.0, 128), (-37_430.3, -25_024.3)),
], ids=["h2_one_run", "h2_three_runs", "h3"])
def test_hv0_bands(records, n, stats, band):
    """The Heavy-v0 H2 records (3 x 128 JAX episodes) and H3's (128) give
    the bands held for one run, for three runs pooled and for H3."""
    mean, sd, n_jax, got = report.record_band(records, n)
    assert (round(mean, 1), round(sd, 1), n_jax) == stats
    assert tuple(round(x, 1) for x in got) == band


def test_h3_counts_past_int32():
    """H3 ends past 2^31 steps: the port's int64 count 2,399,141,888 in its
    log and eval rows, the JAX log's and eval row's int32 -1,895,825,408,
    the same modulo 2^32 and not otherwise."""
    jax_last = report.updates(report.RECORDS / "ppo_hv0_H3_r5.jsonl")[-1]["timesteps"]
    jax_row = json.loads((report.RECORDS / "eval_hv0_H3_r5_seed0.json").read_text())
    port_last = report.updates(report.leg_log("hv0h3", 2))[-1]["timesteps"]
    assert jax_last == jax_row["trained_timesteps"] == -1_895_825_408
    assert port_last == report.RUNS["hv0h3"].steps == 2_399_141_888 > 2**31
    assert (port_last - jax_last) % 2**32 == 0 and port_last != jax_last
    for k in range(3):
        row = json.loads(report.paths("hv0h3")[1](k).read_text())
        assert row["trained_timesteps"] == port_last


@pytest.mark.parametrize("group, missed", [
    ("hv2", ["hv2"]), ("cnn4", []), ("hv0h2", []), ("hv0c_curB", ["hv0c_curB"]),
    ("hv0c_x2", ["hv0c_x2", "hv0c3_x2"]), ("hv0c_x3", ["hv0c_x3"]), ("hv0c_x4", ["hv0c_x4"]),
    ("hv0c_h2", []),
])
def test_seed_rule_needs_a_miss(group, missed):
    """The seed-spread rule judges only a run that missed its own band: the
    Heavy-v2 run at seed 3 did, no Heavy-v0 H2 run and no pixel run did; of
    the Heavy-v0 curriculum's three chains the first missed at curB, X2, X3
    and X4 (its H2, from its own X4, did not), the second nowhere, the third
    at X2 (above its band)."""
    assert report.seed_pool(group)["missed"] == missed


HV0C = [f"{chain}_{leg[0]}" for chain in ("hv0c", "hv0c2", "hv0c3")
        for leg in report.HV0C_LEGS]


@pytest.mark.parametrize("run", ["hv0h2_s0", "hv0h2_s1", "hv0h2_s2", "hv0h3"] + HV0C)
def test_graphs_captured_once_per_leg(run):
    """Every leg of the Heavy-v0 runs (524,288 samples per update in H2 and
    H3, 1,048,576 in the curriculum's curB and X legs, whose learner graph
    holds 4 x 64 minibatch steps) captured the rollout's and the learner's
    graph once each: no recapture mid-leg."""
    for k in range(len(report.RUNS[run].jax_legs)):
        assert report.captures(report.leg_log(run, k + 1)) == {"rollout": 1, "learner": 1}


@pytest.mark.parametrize("leg, stats, band, completions", [
    ("curB", (-39_269.4, 24_115.4, 256), (-45_106.8, -33_432.0), 170),
    ("x2", (-34_726.4, 23_588.5, 384), (-39_833.5, -29_619.4), 301),
    ("x3", (-25_632.3, 17_684.1, 384), (-29_461.0, -21_803.6), 316),
    ("x4", (-17_513.5, 13_888.1, 384), (-20_520.4, -14_506.7), 301),
    ("h2", (-20_823.9, 15_496.5, 384), (-24_179.0, -17_468.8), 355),
])
def test_hv0c_bands(leg, stats, band, completions):
    """The JAX records of each leg of the Heavy-v0 curriculum (curB's two
    deterministic eval seeds, X2-X4's and H2's three) give the band each
    leg of ``hv0c`` is held to over its 384 episodes, and the records'
    episodes that ended before the 3000-step limit."""
    records = report.RUNS[f"hv0c_{leg}"].records
    mean, sd, n_jax, got = report.record_band(records, 384)
    assert (round(mean, 1), round(sd, 1), n_jax) == stats
    assert tuple(round(x, 1) for x in got) == band
    lengths = np.concatenate([json.loads((report.RECORDS / f).read_text())["lengths"]
                              for f in records])
    assert int((lengths < 3000).sum()) == completions


RESUMED = [run for run in report.RUNS if report.RUNS[run].before]


@pytest.mark.parametrize("run", RESUMED)
def test_resumed_leg_continues_the_one_before(run):
    """A leg that carries on from the run before it (a whole TrainState by
    ``--resume``, or the exported policy by ``--resume_policy``) starts at
    that run's last step count: the CLI's ``resumed from`` / ``warm-started
    policy from`` line says so, and its update 0 logs that count plus one
    update's steps, as the JAX run's leg does."""
    spec = report.RUNS[run]
    n = len(report.RUNS[spec.before].jax_legs) + 1
    path = report.leg_log(run, n)
    before = report.updates(report.leg_log(spec.before, n - 1))[-1]["timesteps"]
    cfg = report.config(path)
    first = report.updates(path)[0]["timesteps"]
    assert first == before + int(cfg["n_envs"]) * int(cfg["n_steps"])
    start = path.read_text().splitlines()[1]
    assert start.startswith(("resumed from ", "warm-started policy from "))
    assert start.endswith(f" at {before} steps")
    jax = [report.updates(report.RECORDS / f) for f in spec.jax_legs[-2:]]
    assert jax[1][0]["timesteps"] - jax[0][-1]["timesteps"] == first - before
