"""The port's sweeps (``train/sweep.py``) and profiling helpers
(``utils/profiling.py``) on the CPU: the search space, its samples and the
wandb config against the JAX package's; a tiny fast sweep (dynamic knobs
only, ranked best first, only the best trial's state kept); the determinism
check and the tracer."""

import json
import math
import random

import numpy as np
import pytest
import torch

from gym_puzzles_tpu.train import sweep as jsweep
from gym_puzzles_tpu_torch.api.registry import make
from gym_puzzles_tpu_torch.train import sweep
from gym_puzzles_tpu_torch.train.ppo import PPOConfig, TrainState
from gym_puzzles_tpu_torch.utils import profiling

torch.set_num_threads(1)

ITERS = dict(velocity_iters=8, position_iters=4)


def test_space_and_samples_match_jax():
    assert sweep.SWEEP_SPACE == jsweep.SWEEP_SPACE
    assert sweep.DYNAMIC_KNOBS == jsweep.DYNAMIC_KNOBS
    assert sweep.METRIC == jsweep.METRIC
    for s in (0, 1, 7, 123):
        got = sweep.sample_params(random.Random(s))
        assert got == jsweep.sample_params(random.Random(s))
        assert set(got) == set(sweep.SWEEP_SPACE) and 1e-5 <= got["learning_rate"] <= 1e-2
    space = {"gamma": {"values": [0.99, 0.999]}, "learning_rate": {"min": -9.2, "max": -6.9}}
    assert sweep._sample_space(random.Random(3), space) == \
        jsweep._sample_space(random.Random(3), space)


def test_wandb_sweep_config():
    cfg = sweep.wandb_sweep_config()
    assert cfg["metric"]["name"] == "rollout/ep_rew_mean" and cfg["method"] == "bayes"
    assert cfg["program"] == "python -m gym_puzzles_tpu_torch.train.cli"
    assert cfg["parameters"] == jsweep.wandb_sweep_config()["parameters"]


def test_run_fast_sweep():
    """Two trials of one update each through one learner, ranked by a
    one-step batched eval (the eval env keeps the reference's 180/60): rows best first, only ``results[0]`` keeps a
    TrainState, each trial's hparams set from its sample; a knob that is
    not dynamic raises."""
    cfg = PPOConfig(n_envs=2, n_steps=4, batch_size=4, n_epochs=1, seed=0, **ITERS)
    space = {"learning_rate": {"min": math.log(1e-4), "max": math.log(1e-3)},
             "ent_coef": {"values": [0.0, 0.01]}}
    logged = []
    results = sweep.run_fast_sweep(cfg, trials=2, budget_timesteps=8, seed=5, space=space,
                                   eval_episodes=2, eval_max_steps=1, log=logged.append,
                                   device="cpu")
    assert len(results) == 2 and sorted(r["trial"] for r in results) == [0, 1]
    assert results[0]["score"] >= results[1]["score"]
    assert all(r["score"] == r["eval_mean"] and np.isfinite(r["eval_std"]) for r in results)
    assert isinstance(results[0]["final_state"], TrainState)
    assert results[1]["final_state"] is None
    best = results[0]["final_state"]
    assert int(best.timesteps) == 8
    assert best.hparams.learning_rate == np.float32(results[0]["params"]["learning_rate"])
    rows = [json.loads(line) for line in logged]
    assert [row["trial"] for row in rows] == [0, 1]
    assert rows[0]["params"] == sweep._sample_space(random.Random(5), space)
    with pytest.raises(ValueError, match="n_steps"):
        sweep.run_fast_sweep(cfg, trials=1, space={"n_steps": {"values": [4]}}, device="cpu")


def test_sweep_cli(tmp_path, capsys):
    """``--mode fast`` on the CPU writes one JSON row per trial to ``--out``;
    ``--mode full`` refuses the flags it cannot honour."""
    out = tmp_path / "rows.jsonl"
    results = sweep.main(["--device", "cpu", "--velocity_iters", "8", "--position_iters", "4",
                          "--n_envs", "2", "--n_steps", "4", "--batch_size", "4",
                          "--n_epochs", "1", "--trials", "1", "--budget_timesteps", "8",
                          "--seed", "3", "--out", str(out)])
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == len(results) == 1 and rows[0]["trial"] == 0
    assert set(rows[0]["params"]) == {k for k in sweep.SWEEP_SPACE if k in sweep.DYNAMIC_KNOBS}
    with pytest.raises(SystemExit):
        sweep.main(["--mode", "full", "--velocity_iters", "8"])
    assert "does not support: --velocity_iters" in capsys.readouterr().err


def test_profiling_helpers(tmp_path):
    """``assert_deterministic`` passes an env step (tensor trees compared
    bitwise) and fails a random draw; ``trace(None)`` is a no-op and
    ``trace(dir)`` writes a Chrome trace."""
    env = make("MultiRobotPuzzle-v0", num_envs=2, device="cpu", **ITERS)
    state, _ = env.reset(seed=0)
    action = torch.rand((2, 6), generator=torch.Generator().manual_seed(1)) * 2 - 1
    out = profiling.assert_deterministic(lambda: env.step(state, action)[:4])
    assert out[1].shape == (2, 28)
    with pytest.raises(AssertionError):
        profiling.assert_deterministic(lambda: {"x": torch.rand(3)})
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path / "tb")) as prof:
        torch.ones(4).sum()
    assert prof is not None and (tmp_path / "tb" / "trace.json").is_file()
