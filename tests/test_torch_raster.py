"""The port's host renderer (``gym_puzzles_tpu_torch.render.raster`` on the
C++ core ``csrc/_raster.cpp``) against the JAX package's
(``gym_puzzles_tpu.render.raster``) on the CPU, on the same ``reset_fast``
states carried across with ``convert``: every pixel equal.  Also the C++
core against its plain numpy version, the port's on-device renderer against
its host raster, the single-env ``ImageObsEnv`` against the JAX one's shapes
and stack, and ``record_video``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from gym_puzzles_tpu.api.image_obs import ImageObsEnv as JaxImageObsEnv
from gym_puzzles_tpu.render import raster as jraster
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api.image_obs import ImageObsEnv
from gym_puzzles_tpu_torch.api.registry import _logic as torch_logic
from gym_puzzles_tpu_torch.render import _raster_cpp as cpp
from gym_puzzles_tpu_torch.render import raster
from gym_puzzles_tpu_torch.render.device import make_device_renderer
from gym_puzzles_tpu_torch.train import evaluate
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig
from torch_port_helpers import jax_env, jax_spawns, np_tree

torch.set_num_threads(1)

ITERS = dict(velocity_iters=8, position_iters=4)
E = 4
CASES = [("MultiRobotPuzzle-v0", "human_vision"), ("MultiRobotPuzzle-v2", "human_vision"),
         ("MultiRobotPuzzle-v2", "agent_vision"), ("MultiRobotPuzzle-v3", "human_vision"),
         ("MultiRobotPuzzleHeavy-v0", "human_vision")]


def env_slice(state, i):
    """Env ``i`` of a batched state (env axis last), as an unbatched state."""
    if dataclasses.is_dataclass(state):
        return type(state)(**{f.name: env_slice(getattr(state, f.name), i)
                              for f in dataclasses.fields(state)})
    return state[..., i]


@pytest.mark.parametrize("env_id,mode", CASES)
def test_render_matches_jax(env_id, mode):
    """``render_batch`` and ``render_state`` equal the JAX host renderer's
    frames in every pixel."""
    jenv = jax_env(env_id, E)
    jstate, _ = jax_spawns(jenv, seed=5)
    want = jraster.render_batch(jenv.logic, jstate, mode=mode)
    logic = torch_logic(env_id)
    state = convert.state_from_numpy(np_tree(jstate))
    got = raster.render_batch(logic, state, mode=mode)
    assert got.shape == want.shape and got.dtype == np.uint8
    n_diff = int((got != want).any(axis=-1).sum())
    print(f"{env_id} {mode}: {n_diff} of {got[..., 0].size} pixels differ")
    assert n_diff == 0
    one = raster.render_state(logic, env_slice(state, 2), mode=mode)
    assert np.array_equal(one, want[2])
    assert np.array_equal(raster.render_batch(logic, state, [3, 1], mode=mode), want[[3, 1]])


def test_cpp_core_matches_numpy():
    """The C++ fills against the numpy ones they replace: a triangle at
    >= 0.995 of the pixels (the JAX package's bound), discs and a ring, and
    a line against the numpy line."""
    tri = np.array([[5.0, 5.0], [50.0, 10.0], [20.0, 55.0]])
    pairs = []
    for fill_cpp, fill_np in (
            (lambda img: cpp.fill_polygon(img, tri.astype(np.float32), (255, 10, 20)),
             lambda img: raster._fill_polygon(img, tri, (255, 10, 20))),
            (lambda img: cpp.fill_circle(img, 30.3, 28.7, 12.5, (1, 2, 3)),
             lambda img: raster._fill_circle(img, 30.3, 28.7, 12.5, (1, 2, 3))),
            (lambda img: cpp.fill_circle(img, 30.3, 28.7, 20.0, (9, 8, 7), False, 3.0),
             lambda img: raster._fill_circle(img, 30.3, 28.7, 20.0, (9, 8, 7), False, 3.0)),
            (lambda img: cpp.draw_line(img, 3.2, 60.1, 58.7, 4.4, (5, 5, 5)),
             lambda img: raster._draw_line(img, (3.2, 60.1), (58.7, 4.4), (5, 5, 5)))):
        a, b = np.zeros((64, 64, 3), np.uint8), np.zeros((64, 64, 3), np.uint8)
        fill_cpp(a)
        fill_np(b)
        assert (b != 0).any()
        pairs.append(float((a == b).all(axis=-1).mean()))
    print(f"C++ against numpy, equal pixel share: {pairs}")
    assert min(pairs) >= 0.995


def test_cpp_build_failure_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's message (no
    fallback to numpy)."""
    bad = tmp_path / "_raster.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(cpp, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        cpp.build()


@pytest.mark.parametrize("env_id,mode", [("MultiRobotPuzzle-v0", "human_vision"),
                                         ("MultiRobotPuzzle-v2", "agent_vision"),
                                         ("MultiRobotPuzzle-v3", "human_vision")])
def test_device_renderer_matches_host(env_id, mode):
    """The port's on-device renderer equals its host raster sliced at
    downsample 4, every pixel (the JAX package's
    ``test_device_renderer_matches_host``)."""
    logic = torch_logic(env_id)
    state, _ = logic.reset_fast(torch.Generator().manual_seed(5), E, logic.default_params())
    dev = make_device_renderer(logic, downsample=4, mode=mode)(state).numpy()
    host = raster.render_batch(logic, state, mode=mode)[:, ::4, ::4]
    assert dev.shape == host.shape
    assert (dev == host).all(axis=-1).mean() == 1.0


def test_image_obs_env_matches_jax():
    """``ImageObsEnv``: the JAX one's obs shape and dtype (depth 2, frameskip
    4, downsample 2), a zero-padded stack after reset, the stack shifting by
    one host-rendered frame per step."""
    env = ImageObsEnv(obs_depth=2, frameskip=4, downsample=2, device="cpu", **ITERS)
    jenv = JaxImageObsEnv(obs_depth=2, frameskip=4, downsample=2)
    assert env.observation_shape == jenv.observation_shape == (2 * 240, 320, 3)
    obs = env.reset()
    assert obs.shape == (2 * 240, 320, 3) and obs.dtype == np.uint8
    assert (obs[:240] == 0).all() and (obs[240:] > 0).any()
    frame = lambda: raster.render_batch(env._logic, env._state, [0])[0][::2, ::2]  # noqa: E731
    assert np.array_equal(obs[240:], frame())
    nxt, r, d, info = env.step(np.zeros(6, np.float32))
    assert nxt.shape == obs.shape and nxt.dtype == np.uint8
    assert isinstance(r, float) and isinstance(d, bool) and isinstance(info["done_status"], int)
    assert np.array_equal(nxt[:240], obs[240:])
    assert np.array_equal(nxt[240:], frame())
    assert int(env._state.t[0]) == 1  # one env step, four engine ticks
    with pytest.raises(ValueError, match="v0 capability"):
        ImageObsEnv("MultiRobotPuzzle-v2", device="cpu")


def test_record_video(tmp_path):
    """Three steps of a fresh policy: ``path.npz`` holds the frames, and they
    equal the host raster of the states the same deterministic rollout
    passes through."""
    cfg = PPOConfig(n_envs=1, n_steps=2, batch_size=2, n_epochs=1, seed=2, **ITERS)
    algo = PPO(cfg, device="cpu")
    ts = algo.init_state()
    frames = evaluate.record_video(algo, ts, str(tmp_path / "clip"), n_steps=3, seed=4, **ITERS)
    with np.load(tmp_path / "clip.npz") as f:
        saved, fps = f["frames"], int(f["fps"])
    assert saved.shape == (3, 480, 640, 3) and saved.dtype == np.uint8 and fps == 50
    assert np.array_equal(saved, frames)

    env = evaluate.make_eval_env(cfg.env_id, 1, "cpu", **ITERS)
    state, obs = env.reset(seed=4)
    for k in range(3):
        assert np.array_equal(saved[k], raster.render_batch(env.logic, state, [0])[0])
        action = evaluate.policy_action(algo, ts.params, ts.normalizer, obs, True)
        state, obs, _r, _d, _i = env.step(state, action)
    assert not np.array_equal(saved[0], saved[2])
