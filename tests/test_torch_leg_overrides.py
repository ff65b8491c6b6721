"""The Heavy-v0 curriculum's X3 -> X4 resume (``torch_h100_ppo_recipes.sh
hv0c``) through the train CLI on the CPU, against the JAX package's CLI on
the same flags: X3 trains with shaped rewards (agentDistance 0.02,
blockDistance 0.05) at gamma 0.997; X4 names no ``--set_reward_params``, so
the TrainState it resumes must come back to the Heavy-v0 default rewards
(not keep X3's), its normalizer must discount at X4's 0.999 while the
return moments carry over from X3, and its hyperparameters must be X4's.
The port's X3 leg trains one update at 2/1 solver iterations (so the moments
it carries are not the initial ones); every other leg's ``learn`` is swapped
for a spy that records the state it is given, so nothing of the JAX learner
compiles."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from gym_puzzles_tpu.train import cli as jcli
from gym_puzzles_tpu.train import ppo as jppo
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train import cli
from gym_puzzles_tpu_torch.train.ppo import PPO, HParams

torch.set_num_threads(1)

BASE = ["--disable_wandb", "--env", "MultiRobotPuzzleHeavy-v0", "--n_envs", "4", "--n_steps",
        "4", "--batch_size", "8", "--n_epochs", "1", "--velocity_iters", "2",
        "--position_iters", "1", "--total_timesteps", "16"]
# the legs' flags as torch_h100_ppo_recipes.sh hv0c gives them (but the size)
X3 = ["--learning_rate", "0.00063", "--gamma", "0.997", "--gae_lambda", "0.98", "--clip_range",
      "0.2", "--ent_coef", "0.0005", "--set_reward_params",
      "agentDelta=5,agentDistance=0.02,blockDelta=2000,blockDistance=0.05", "--seed", "31"]
X4 = ["--learning_rate", "0.0001", "--gamma", "0.999", "--gae_lambda", "0.95", "--clip_range",
      "0.1", "--ent_coef", "0.0002", "--seed", "41"]
SHAPED = {"weight_agent_dist": 0.02, "weight_blk_dist": 0.05, "weight_delta_agent": 5.0,
          "weight_delta_block": 2000.0}


def f32(x) -> np.float32:
    return np.float32(np.asarray(x.item() if isinstance(x, torch.Tensor) else x))


def spy(monkeypatch, cls, seen):
    """Swap ``cls.learn`` for one that records the state it is given and
    returns it untrained."""

    def learn(self, total_timesteps=None, log_fn=None, state=None, **kw):
        seen["state"] = state
        return state

    monkeypatch.setattr(cls, "learn", learn)


@pytest.fixture(scope="module")
def jax_legs(tmp_path_factory):
    """The JAX CLI's X3 leg saved (an initial state), then its X4 leg's
    resumed state."""
    path = tmp_path_factory.mktemp("jax")
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        spy(mp, jppo.PPO, seen)
        jcli.main(BASE + X3 + ["--save_model", "--checkpoint_dir", str(path)])
        x3 = seen["state"]
        jcli.main(BASE + X4 + ["--resume", str(path / "MultiRobotPuzzleHeavy-v0")])
    return x3, seen["state"]


@pytest.fixture(scope="module")
def port_legs(tmp_path_factory):
    """The port's CLI on the same flags: the X3 checkpoint's tree after one
    update, then the state its X4 leg resumes."""
    path = tmp_path_factory.mktemp("port")
    cli.main(["--device", "cpu"] + BASE + X3 + ["--save_model", "--checkpoint_dir", str(path)])
    saved = ckpt.load(path / "MultiRobotPuzzleHeavy-v0")
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        spy(mp, PPO, seen)
        cli.main(["--device", "cpu"] + BASE + X4 + ["--resume",
                                                    str(path / "MultiRobotPuzzleHeavy-v0")])
    return saved, seen["state"]


def test_x3_checkpoint_holds_shaped_rewards(jax_legs, port_legs):
    """The X3 leg trains with its shaped rewards and gamma 0.997 in both
    packages, field for field (what the X4 resume has to undo)."""
    jx3, _ = jax_legs
    saved, _ = port_legs
    for field, value in saved["env_params"].items():
        assert f32(value) == f32(getattr(jx3.env_params, field)), field
    for field, value in SHAPED.items():
        assert f32(saved["env_params"][field]) == np.float32(value), field
    assert f32(saved["normalizer"]["gamma"]) == f32(jx3.normalizer.gamma) == np.float32(0.997)


def test_x4_resume_matches_jax_cli(jax_legs, port_legs):
    """X4's resumed TrainState: the reward params are the Heavy-v0 defaults
    as the JAX CLI builds them (no field of X3's shaping left), the
    normalizer's gamma is 0.999 in both, its moments are X3's, and the
    hyperparameters are X4's, each field equal to the JAX ``HParams``."""
    _, jx4 = jax_legs
    saved, x4 = port_legs
    for field in dataclasses.fields(x4.env_params):
        got, want = f32(getattr(x4.env_params, field.name)), f32(getattr(jx4.env_params,
                                                                        field.name))
        assert got.view(np.uint32) == want.view(np.uint32), (field.name, got, want)
    for field, value in SHAPED.items():
        assert f32(getattr(x4.env_params, field)) != np.float32(value), field
    assert f32(x4.normalizer.gamma) == f32(jx4.normalizer.gamma) == np.float32(0.999)
    assert float(saved["normalizer"]["ret_rms"]["count"]) > 1  # X3 trained: moments moved
    for rms in ("obs_rms", "ret_rms"):
        for k, v in saved["normalizer"][rms].items():
            np.testing.assert_array_equal(getattr(getattr(x4.normalizer, rms), k).numpy(),
                                          np.asarray(v))
    assert dataclasses.asdict(x4.hparams) == dataclasses.asdict(HParams(**{
        k: float(f32(getattr(jx4.hparams, k))) for k in dataclasses.asdict(x4.hparams)}))
    assert f32(x4.hparams.learning_rate) == np.float32(1e-4)
    assert int(x4.timesteps) == int(saved["timesteps"])
