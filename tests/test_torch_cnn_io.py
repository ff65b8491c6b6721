"""The pixel policy's checkpoints, policy file, evaluation and CLIs on the
CPU: exact resume of a CNN learner, ``restore_policy`` from its checkpoint
and from its exported ``.npz`` (which records the image pipeline) into an
image template, frames never normalized at evaluation, the eval CLI on the
pixel policy file, ``--policy cnn`` in the trainer CLI, and
``max_episode_steps`` refused with ``policy='cnn'``."""

import json

import numpy as np
import pytest
import torch

from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train import cli, evaluate, export
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig
from torch_port_helpers import assert_trees_equal

torch.set_num_threads(1)

ITERS = dict(velocity_iters=8, position_iters=4)
DOWNSAMPLE = 16
PIPELINE = (3, 4, DOWNSAMPLE, "human_vision", "t")


def cnn_cfg(**kw):
    return PPOConfig(**{**dict(env_id="MultiRobotPuzzle-v0", policy="cnn", n_envs=2, n_steps=4,
                               batch_size=4, n_epochs=2, seed=3, **ITERS), **kw})


def cnn_learner(n_envs=2, frameskip=4):
    env = DeviceImageVectorEnv(num_envs=n_envs, frameskip=frameskip, downsample=DOWNSAMPLE,
                               device="cpu", **ITERS)
    return PPO(cnn_cfg(n_envs=n_envs), env=env)


@pytest.fixture(scope="module")
def cnn_update(tmp_path_factory):
    """A checkpoint of a fresh CNN learner after one update."""
    path = tmp_path_factory.mktemp("cnn_update")
    algo = cnn_learner()
    ts, _ = algo.train_step(algo.init_state())
    ckpt.save(path, ts, ckpt.step_count(ts.timesteps))
    return path


def test_cnn_exact_resume(cnn_update):
    """Two updates in a row equal one update, save, restore into a fresh
    learner, one update: params, Adam state, normalizer, env state and
    frames, both generators and the metrics, bitwise."""
    algo = cnn_learner()
    ts = algo.init_state()
    assert ts.last_obs.dtype == torch.uint8 and ts.vstate.frames.shape == (2, 3, 30, 40, 3)
    for _ in range(2):
        ts, m = algo.train_step(ts)
    resumed = cnn_learner()
    rs = ckpt.restore(cnn_update, resumed.init_state())
    assert rs.env_generator is resumed.env.generator
    rs, rm = resumed.train_step(rs)
    assert_trees_equal(rs, ts)
    assert_trees_equal(rm, m)
    assert int(ts.timesteps) == 16


def test_cnn_restore_policy_and_npz(cnn_update, tmp_path):
    """The checkpoint and its exported policy file graft into an image
    template of another batch size; both record the pipeline, and neither
    restores into a learner whose frames are made another way."""
    full = ckpt.restore(cnn_update, cnn_learner().init_state())
    assert full.image_pipeline == PIPELINE
    export.export(cnn_update, tmp_path / "policy.npz")
    pol = convert.policy_from_npz(tmp_path / "policy.npz")
    assert pol.image_pipeline == PIPELINE and pol.net.obs_shape == (90, 40, 3)
    eval_algo = cnn_learner(n_envs=3)
    other = cnn_learner(frameskip=2).init_state()
    for source in (cnn_update, tmp_path / "policy.npz"):
        got = ckpt.restore_policy(source, eval_algo.init_state())
        assert_trees_equal(got.params, full.params)
        assert_trees_equal(got.normalizer.ret_rms, full.normalizer.ret_rms)
        assert got.vstate.frames.shape[0] == 3 and int(got.timesteps) == 8
        with pytest.raises(ValueError, match="image pipeline"):
            ckpt.restore_policy(source, other)
    with pytest.raises(ValueError, match="image pipeline"):
        ckpt.restore(cnn_update, other)


def test_policy_action_leaves_frames_unnormalized(cnn_update):
    """With ``normalize`` on, a pixel policy's obs go to the network as they
    are (the JAX package's ``_use_obs_norm``)."""
    algo = cnn_learner()
    assert algo.cfg.normalize and not algo.use_obs_norm
    ts = ckpt.restore_policy(cnn_update, algo.init_state())
    with torch.no_grad():
        act = evaluate.policy_action(algo, ts.params, ts.normalizer, ts.last_obs, True)
        mean = algo.apply(ts.params, ts.last_obs)[0]
    assert torch.equal(act, torch.clamp(mean, -1.0, 1.0))


def test_eval_cli_on_pixel_policy(cnn_update, tmp_path, capsys):
    """The eval CLI rebuilds the image env from the policy file."""
    export.export(cnn_update, tmp_path / "policy.npz")
    capsys.readouterr()
    evaluate.main(["--checkpoint", str(tmp_path / "policy.npz"), "--device", "cpu",
                   "--n_episodes", "2", "--max_steps", "3", "--batched",
                   "--velocity_iters", "8", "--position_iters", "4"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["policy"] == "cnn" and row["image_pipeline"] == list(PIPELINE)
    assert row["trained_timesteps"] == 8 and row["lengths"] == [3, 3]


def test_train_cli_cnn(tmp_path):
    """``--policy cnn`` trains on the default image pipeline (3 stacked
    120 x 160 frames); ``--max_episode_steps`` is refused with it."""
    base = ["--device", "cpu", "--disable_wandb", "--policy", "cnn", "--n_envs", "2",
            "--n_steps", "2", "--batch_size", "4", "--n_epochs", "1", "--velocity_iters", "2",
            "--position_iters", "1"]
    final = cli.main(base + ["--total_timesteps", "4"])
    assert final.last_obs.shape == (2, 360, 160, 3) and int(final.timesteps) == 4
    assert "convs.0.weight" in final.params
    with pytest.raises(ValueError, match="max_episode_steps"):
        cli.main(base + ["--total_timesteps", "4", "--max_episode_steps", "100"])
    with pytest.raises(ValueError, match="policy must be"):
        PPO(cnn_cfg(policy="transformer"), device="cpu")
    np.testing.assert_array_equal(final.normalizer.obs_rms.mean.numpy(), np.zeros(28))
