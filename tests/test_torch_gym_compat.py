"""The port's host surface against the JAX package's on the CPU: the old-Gym
single env (``GymPuzzleEnv``: shapes and types, the reward hooks, one step
from the same state), the gymnasium vector adapter's terminated / truncated
split, ``VectorEnv.single_*_space`` with and without gymnasium, the live
viewer's headless ANSI sink and ``teleop.frame_to_ansi``."""

import contextlib
import dataclasses
import io
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_puzzles_tpu import teleop as jteleop
from gym_puzzles_tpu.api import gym_compat as jgc
from gym_puzzles_tpu.api import registry as jreg
from gym_puzzles_tpu_torch import convert, teleop
from gym_puzzles_tpu_torch.api import gym_compat as tgc
from gym_puzzles_tpu_torch.api import registry as treg
from gym_puzzles_tpu_torch.render.raster import render_batch
from torch_port_helpers import np_tree

torch.set_num_threads(1)

ITERS = dict(velocity_iters=8, position_iters=4)
DIMS = {"MultiRobotPuzzle-v0": (28, 6), "MultiRobotPuzzle-v2": (39, 4),
        "MultiRobotPuzzle-v3": (27, 6)}


def with_env_axis(tree):
    """An unbatched state tree (nested dicts of numpy arrays) with a
    trailing env axis of 1."""
    if isinstance(tree, dict):
        return {k: with_env_axis(v) for k, v in tree.items()}
    return np.asarray(tree)[..., None]


@pytest.mark.parametrize("env_id", list(DIMS))
def test_gym_env_shapes_and_types(env_id):
    """The JAX package's ``test_gym_single_env_adapter`` contract on each
    family, and ``seed`` / ``reset`` as the generator's stream."""
    obs_dim, act_dim = DIMS[env_id]
    env = tgc.GymPuzzleEnv(env_id, seed=1, device="cpu", **ITERS)
    obs = env.reset()
    assert obs.shape == (obs_dim,) and obs.dtype == np.float32
    obs, r, d, info = env.step(np.zeros(act_dim, np.float32))
    assert obs.shape == (obs_dim,) and obs.dtype == np.float32
    assert isinstance(r, float) and isinstance(d, bool)
    assert list(info) == ["done_status"] and isinstance(info["done_status"], int)
    assert env.observation_space.shape == (obs_dim,)
    assert env.action_space.shape == (act_dim,) and float(env.action_space.low[0]) == -1.0
    env.seed(1)
    first, second = env.reset(), env.reset()
    env.seed(1)
    assert np.array_equal(env.reset(), first) and not np.array_equal(first, second)


@pytest.mark.parametrize("env_id", list(DIMS))
def test_reward_hooks_match_jax(env_id):
    """``set_reward_params`` / ``update_params`` / ``update_goal`` leave the
    same RewardParams as the JAX class, leaf by leaf, bitwise."""
    jenv = jgc.GymPuzzleEnv(env_id, seed=0)
    tenv = tgc.GymPuzzleEnv(env_id, seed=0, device="cpu", **ITERS)
    for env in (jenv, tenv):
        env.set_reward_params(agentDelta=5.0, blockDistance=0.03, outOfBounds=500.0,
                              puzzleComp=123.4)
        env.update_params(10, 0.999)
        env.update_goal(1, 10)
    for f in dataclasses.fields(tenv._params):
        want = np.asarray(getattr(jenv._params, f.name), np.float32)
        got = np.float32(getattr(tenv._params, f.name))
        assert got.tobytes() == want.tobytes(), (f.name, got, want)
    assert tenv._params.weight_delta_agent == 5.0


# spawn seeds whose spawn and step stay free of contact
@pytest.mark.parametrize("env_id,seed,oob", [("MultiRobotPuzzle-v0", 5, False),
                                             ("MultiRobotPuzzle-v2", 3, False),
                                             ("MultiRobotPuzzle-v3", 1, False),
                                             ("MultiRobotPuzzle-v2", 4, True)])
def test_step_matches_jax(env_id, seed, oob):
    """One ``step`` from a JAX spawn (with an agent moved out of bounds:
    ``done_status`` 1) against JAX ``logic.step`` on the same state and
    action: obs and reward within the no-contact contract (1e-4), ``done``
    and ``done_status`` equal."""
    jl = jreg._logic(env_id, **ITERS)
    state, _ = jax.jit(jl.reset_fast)(jax.random.key(seed), jl.default_params())
    slot = int(jl.layout.agent_slots[0])
    if oob:  # agent 0 at x = -1 m: beyond the bounds (0.1 m), clear of the wall
        state = state.replace(bodies=state.bodies.replace(
            pos=state.bodies.pos.at[slot, 0].set(-1.0)))
    action = np.random.RandomState(seed).uniform(-1, 1, DIMS[env_id][1]).astype(np.float32)
    js, jobs, jrew, jdone, jinfo = jax.jit(jl.step)(state, jnp.asarray(action),
                                                     jl.default_params())
    assert not np.asarray(js.contacts.touching).any()

    env = tgc.GymPuzzleEnv(env_id, device="cpu", **ITERS)
    env._state = convert.state_from_numpy(with_env_axis(np_tree(state)))
    obs, reward, done, info = env.step(action)
    print(f"{env_id} oob={oob}: max |obs diff| {np.abs(obs - np.asarray(jobs)).max():.3e}, "
          f"|reward diff| {abs(reward - float(jrew)):.3e}")
    np.testing.assert_allclose(obs, np.asarray(jobs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(reward, float(jrew), rtol=1e-4, atol=1e-4)
    assert done == bool(jdone) and info["done_status"] == int(jinfo["done_status"])
    assert info["done_status"] == (1 if oob else 0)


def test_gymnasium_adapter_splits_terminated_and_truncated():
    """An agent out of bounds terminates its lane (not truncated); the step
    limit truncates the others (not terminated)."""
    env = tgc.GymnasiumVectorAdapter("MultiRobotPuzzle-v2", num_envs=3, device="cpu",
                                     max_episode_steps=2, **ITERS)
    obs, info = env.reset(seed=0)
    assert obs.shape == (3, 39) and info == {}
    slot = int(env.env.logic.layout.agent_slots[0])
    pos = env._state.bodies.pos.clone()
    pos[slot, 0, 0] = -1.0
    env._state = env._state.replace(bodies=env._state.bodies.replace(pos=pos))
    obs, rew, term, trunc, info = env.step(np.zeros((3, 4), np.float32))
    assert obs.shape == (3, 39) and rew.shape == (3,) and rew.dtype == np.float32
    assert term.dtype == bool and trunc.dtype == bool
    assert term.tolist() == [True, False, False] and trunc.tolist() == [False] * 3
    assert info["done_status"].tolist() == [1, 0, 0]
    _obs, _rew, term, trunc, info = env.step(np.zeros((3, 4), np.float32))
    assert term.tolist() == [False] * 3 and trunc.tolist() == [False, True, True]
    assert env.single_observation_space.shape == (39,)


@pytest.mark.parametrize("gymnasium", [True, False])
def test_single_spaces_match_jax(monkeypatch, gymnasium):
    """``VectorEnv.single_*_space``: a gymnasium Box when gymnasium imports,
    the stand-in otherwise, equal to the JAX package's either way."""
    if not gymnasium:
        monkeypatch.setitem(sys.modules, "gymnasium", None)
    env_id = "MultiRobotPuzzle-v0"
    tenv = treg.make(env_id, num_envs=2, device="cpu")
    jenv = jreg.make(env_id, num_envs=2)
    for name, dim, low in (("single_observation_space", 28, float("-inf")),
                           ("single_action_space", 6, -1.0)):
        got, want = getattr(tenv, name), getattr(jenv, name)
        assert got.shape == want.shape == (dim,)
        assert (type(got).__module__.startswith("gymnasium")) == gymnasium
        if gymnasium:
            assert got == want
        else:
            assert (got.low, got.high, got.dtype) == (want.low, want.high, want.dtype)
            assert got.low == low
        assert getattr(tenv, name) is got  # cached


def test_render_human_reaches_ansi_viewer(monkeypatch):
    """``render('human')`` with no display draws ANSI frames through the live
    viewer (the JAX package's ``test_render_human_live_viewer``);
    ``rgb_array`` returns the host raster of the env's state."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    env = tgc.GymPuzzleEnv("MultiRobotPuzzle-v0", seed=0, device="cpu", **ITERS)
    env.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        frame = env.render(mode="human")
    out = buf.getvalue()
    assert frame.shape == (480, 640, 3) and frame.dtype == np.uint8
    assert env._viewer is not None and env._viewer.sink == "ansi"
    assert "\x1b[" in out and len(out) > 5000
    env.close()
    assert env._viewer is None
    rgb = env.render(mode="rgb_array")
    assert np.array_equal(rgb, render_batch(env._logic, env._state, [0])[0])
    agent = env.render(mode="agent")  # points and heading lines only
    assert (agent.sum(axis=2) > 0).sum() < (rgb.sum(axis=2) > 0).sum()


@pytest.mark.parametrize("cols", [32, 100, 110])
def test_frame_to_ansi_matches_jax(cols):
    rng = np.random.RandomState(cols)
    img = rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    assert teleop.frame_to_ansi(img, cols) == jteleop.frame_to_ansi(img, cols)
    env = tgc.GymPuzzleEnv("MultiRobotPuzzle-v3", device="cpu", **ITERS)
    env.reset()
    frame = env.render("rgb_array")
    assert teleop.frame_to_ansi(frame, cols) == jteleop.frame_to_ansi(frame, cols)
