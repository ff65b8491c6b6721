"""The benchmark's plain reference (``portbench/reference``) against the port
at Heavy-v0's shapes (10 bodies, 48 pairs, 5 agents; obs 40, act 15) as at
v0's, on the CPU at 8 envs: the tick and the env logic bit for bit over 12
seeded steps, and the learner on seeded random weights."""

import dataclasses

import pytest
import torch

import gym_puzzles_tpu_torch as gpt
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig
from portbench import check, program
from portbench.loops import ppo_updates
from portbench.reference import config as rconfig
from portbench.reference import learner as rl
from portbench.reference import v0 as rv0

ENV_IDS = ["MultiRobotPuzzle-v0", "MultiRobotPuzzleHeavy-v0"]
WIDTHS = {"MultiRobotPuzzle-v0": (28, 6), "MultiRobotPuzzleHeavy-v0": (40, 15)}


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_tick_and_env_logic_match_the_port(env_id):
    E = 8
    env = gpt.make(env_id, num_envs=E, device="cpu", velocity_iters=8, position_iters=3)
    logic = env.logic
    ref = rv0.Env(dataclasses.replace(rconfig.VARIANTS[env_id], velocity_iters=8,
                                      position_iters=3))
    assert (env.cfg.obs_dim, env.cfg.act_dim) == WIDTHS[env_id]
    assert ref.layout.table.num_pairs == logic.layout.table.num_pairs
    state, _obs = env.reset(seed=3)
    g = torch.Generator().manual_seed(0)
    for _ in range(12):
        a = torch.rand((E, env.cfg.act_dim), generator=g) * 2 - 1
        st, obs, r, d, _info = logic.step_fused(state, a.T, logic.default_params())
        rs, robs, rr, rd, _ = ref.step(check.ref_state(state, "cpu"), a.T, ref.default_params())
        assert torch.equal(robs, obs) and torch.equal(rr, r) and torch.equal(rd, d)
        assert torch.equal(rs.bodies.pos, st.bodies.pos)
        assert torch.equal(rs.bodies.angle, st.bodies.angle)
        state = st


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_learner_matches_the_port_on_seeded_weights(env_id):
    cfg = PPOConfig(env_id=env_id, n_envs=4, n_steps=4, batch_size=8, n_epochs=2,
                    velocity_iters=4, position_iters=2, target_kl=0.01, clip_range=0.1,
                    gamma=0.999, learning_rate=1e-4, ent_coef=2e-4)
    algo = PPO(cfg, device="cpu")
    ts = algo.init_state(seed=1)
    params = program.make_weights(ts.params, 2**31 + 7, "cpu")
    ts = ts.replace(params=params)
    obs_dim, act_dim = WIDTHS[env_id]
    assert params["trunk.0.weight"].shape[1] == obs_dim
    assert params["mean.weight"].shape[0] == act_dim
    start = ts
    ts, traj = algo._rollout(ts, None, None, None, graphed=False)
    perms = torch.stack([torch.randperm(16, generator=torch.Generator().manual_seed(k))
                         for k in range(2)])
    new, _metrics = algo.update(ts, traj, perms=perms, start=start)
    mean, _log_std, value = rl.forward(dict(ts.params), traj.obs[0])
    want = algo.apply(ts.params, traj.obs[0])
    assert torch.allclose(mean, want[0], atol=1e-6) and torch.allclose(value, want[2], atol=1e-6)
    n = ts.normalizer.obs_rms
    last = rl.normalize_obs({"mean": n.mean, "var": n.var, "count": n.count}, ts.last_obs)
    tr = {k: getattr(traj, k) for k in ("obs", "action", "log_prob", "value", "reward", "done")}
    opt = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
           "nu": {k: torch.zeros_like(v) for k, v in params.items()},
           "count": torch.zeros((), dtype=torch.int32)}
    hp = ppo_updates.hparams(dataclasses.asdict(cfg))
    got, got_opt, _loss, _n = rl.update(dict(params), opt, tr, rl.forward(params, last)[2],
                                        perms, hp, cfg.batch_size)
    for k in params:
        assert torch.allclose(got[k], new.params[k], atol=1e-6, rtol=1e-5), k
        assert torch.allclose(got_opt["mu"][k], new.opt_state.mu[k], atol=1e-7), k
