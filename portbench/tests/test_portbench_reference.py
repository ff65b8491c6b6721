"""The frozen reference against the port's plain paths on the CPU at tiny
sizes, and the imports of every module under ``portbench/``."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check
from portbench.loops import ppo_updates
from portbench.reference import config as rconfig
from portbench.reference import learner as rl
from portbench.reference import render as rrender
from portbench.reference import v0 as rv0

BENCH = Path(__file__).resolve().parents[1]


def _ref_env(vi=8, pi=3, frameskip=1):
    cfg = dataclasses.replace(rconfig.VARIANTS["MultiRobotPuzzle-v0"], velocity_iters=vi,
                              position_iters=pi, frameskip=frameskip)
    return rv0.V0Env(cfg)


@pytest.mark.parametrize("frameskip", [1, 2])
def test_tick_and_env_logic_match_the_port(frameskip):
    import gym_puzzles_tpu_torch as gpt
    from gym_puzzles_tpu_torch.api.registry import _image_logic

    E = 8
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=E, device="cpu", velocity_iters=8,
                   position_iters=3)
    logic = env.logic if frameskip == 1 else _image_logic("MultiRobotPuzzle-v0", frameskip,
                                                          velocity_iters=8, position_iters=3)
    ref = _ref_env(frameskip=frameskip)
    state, _obs = env.reset(seed=3)
    g = torch.Generator().manual_seed(0)
    for _ in range(12):
        a = torch.rand((E, env.cfg.act_dim), generator=g) * 2 - 1
        st, obs, r, d, _info = logic.step_fused(state, a.T, logic.default_params())
        rs, robs, rr, rd, _ = ref.step(check.ref_state(state, "cpu"), a.T, ref.default_params())
        assert torch.equal(robs, obs) and torch.equal(rr, r) and torch.equal(rd, d)
        assert torch.equal(rs.bodies.pos, st.bodies.pos)
        # a step's observation is the observation of the state it ends in
        assert torch.equal(robs, ref.observe(rs, ref.default_params()))
        assert torch.equal(ref.observe(check.ref_state(st, "cpu"), ref.default_params()),
                           logic.observe(st, logic.default_params()))
        state = st


def test_renderer_matches_the_port():
    import gym_puzzles_tpu_torch as gpt
    from gym_puzzles_tpu_torch.render.device import make_device_renderer

    env = gpt.make("MultiRobotPuzzle-v0", num_envs=6, device="cpu")
    state, _ = env.reset(seed=5)
    ref = _ref_env(180, 60)
    want = make_device_renderer(env.logic, downsample=4)(state)
    got = rrender.make_device_renderer(ref, downsample=4)(check.ref_state(state, "cpu"))
    assert got.dtype == torch.uint8 and torch.equal(got, want)


@pytest.mark.parametrize("policy", ["mlp", "cnn"])
def test_learner_matches_the_port(policy):
    from gym_puzzles_tpu_torch.train.ppo import AdamState, PPO, PPOConfig

    cfg = PPOConfig(n_envs=4, n_steps=4, batch_size=8, n_epochs=2, policy=policy,
                    velocity_iters=4, position_iters=2, target_kl=0.01)
    algo = PPO(cfg, device="cpu")
    ts = algo.init_state(seed=1)
    start = ts
    ts, traj = algo._rollout(ts, None, lambda _n: __import__("contextlib").nullcontext(),
                             None, graphed=False)
    perms = torch.stack([torch.randperm(16, generator=torch.Generator().manual_seed(k))
                         for k in range(2)])
    new, _metrics = algo.update(ts, traj, perms=perms, start=start)
    hp = ppo_updates.hparams(dict(dataclasses.asdict(cfg)))
    params = dict(ts.params)
    mean, log_std, value = rl.forward(params, traj.obs[0])
    want = algo.apply(params, traj.obs[0])
    assert torch.allclose(mean, want[0], atol=1e-6) and torch.allclose(value, want[2], atol=1e-6)
    last = ts.last_obs
    if algo.use_obs_norm:
        n = ts.normalizer.obs_rms
        last = rl.normalize_obs({"mean": n.mean, "var": n.var, "count": n.count}, last)
    tr = {k: getattr(traj, k) for k in ("obs", "action", "log_prob", "value", "reward", "done")}
    opt = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
           "nu": {k: torch.zeros_like(v) for k, v in params.items()},
           "count": torch.zeros((), dtype=torch.int32)}
    got, got_opt, _loss, _n = rl.update(params, opt, tr, rl.forward(params, last)[2],
                                                   perms, hp, cfg.batch_size)
    for k in params:
        assert torch.allclose(got[k], new.params[k], atol=1e-6, rtol=1e-5), k
        assert torch.allclose(got_opt["mu"][k], new.opt_state.mu[k], atol=1e-7), k
    assert isinstance(new.opt_state, AdamState)


def test_lower_precision_moves_the_forward():
    g = torch.Generator().manual_seed(0)
    params = {"trunk.0.weight": torch.randn(16, 8, generator=g),
              "trunk.0.bias": torch.zeros(16),
              "mean.weight": torch.randn(2, 16, generator=g), "mean.bias": torch.zeros(2),
              "value.weight": torch.randn(1, 16, generator=g), "value.bias": torch.zeros(1),
              "log_std": torch.zeros(2)}
    x = torch.randn(32, 8, generator=g)
    full, low = rl.forward(params, x)[2], rl.forward(params, x, lower=True)[2]
    gap = float((full - low).abs().max() / full.abs().max())
    assert 1e-5 < gap < 1e-2  # TF32's 10 mantissa bits


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(BENCH / path)}
    assert not tops & {"jax", "jaxlib", "flax", "gym_puzzles_tpu"}, tops
    if path.startswith("reference/"):
        assert "gym_puzzles_tpu_torch" not in tops


def test_top_level_names_are_compared_whole():
    from portbench.run import FORBIDDEN

    assert "gym_puzzles_tpu_torch".split(".")[0] not in FORBIDDEN
    assert np.all([n in FORBIDDEN for n in ("jax", "jaxlib", "flax", "gym_puzzles_tpu")])
