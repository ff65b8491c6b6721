"""The benchmark's plain reference of v2's env logic
(``portbench/reference/v2.py``) against the port at MultiRobotPuzzle-v2's and
MultiRobotPuzzleHeavy-v2's shapes (7 bodies, 12 fixtures, 53 pairs; obs 39,
act 4), on the CPU at 8 envs: the tick and the env logic bit for bit over 12
seeded random-action steps, and the reference's test of a fresh spawn."""

import dataclasses

import pytest
import torch

import gym_puzzles_tpu_torch as gpt
from portbench import check
from portbench.reference import config as rconfig
from portbench.reference import v2 as rv2

torch.set_num_threads(1)

ENV_IDS = ["MultiRobotPuzzle-v2", "MultiRobotPuzzleHeavy-v2"]
E = 8


def _pair(env_id):
    env = gpt.make(env_id, num_envs=E, device="cpu", velocity_iters=8, position_iters=3)
    ref = rv2.Env(dataclasses.replace(rconfig.VARIANTS[env_id], velocity_iters=8,
                                      position_iters=3))
    return env, ref


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_tick_and_env_logic_match_the_port(env_id):
    env, ref = _pair(env_id)
    logic = env.logic
    assert (env.cfg.obs_dim, env.cfg.act_dim) == (39, 4)
    assert (ref.layout.table.num_bodies, ref.layout.table.num_pairs) == (7, 53)
    assert ref.layout.table.num_pairs == logic.layout.table.num_pairs
    state, _obs = env.reset(seed=3)
    g = torch.Generator().manual_seed(0)
    for _ in range(12):
        a = torch.rand((E, env.cfg.act_dim), generator=g) * 2 - 1
        st, obs, r, d, info = logic.step_fused(state, a.T, logic.default_params())
        rs, robs, rr, rd, rinfo = ref.step(check.ref_state(state, "cpu"), a.T,
                                           ref.default_params())
        assert torch.equal(robs, obs) and torch.equal(rr, r) and torch.equal(rd, d)
        assert torch.equal(rinfo["done_status"], info["done_status"])
        assert torch.equal(rs.bodies.pos, st.bodies.pos)
        assert torch.equal(rs.bodies.angle, st.bodies.angle)
        assert torch.equal(rs.bodies.omega, st.bodies.omega)
        state = st


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_spawn_bad_tells_a_fresh_spawn_from_a_stepped_state(env_id):
    env, ref = _pair(env_id)
    logic = env.logic
    gen = torch.Generator().manual_seed(11)
    fresh, obs = logic.reset_fast(gen, E, logic.default_params())
    rfresh = check.ref_state(fresh, "cpu")
    assert not ref.spawn_bad(rfresh).any()
    # the reference's spawn from the same draws is the port's, and so is its
    # observation of it
    rstate, robs = ref.reset_fast(torch.Generator().manual_seed(11), E, ref.default_params())
    assert torch.equal(rstate.bodies.pos, fresh.bodies.pos) and torch.equal(robs, obs)
    a = torch.rand((E, env.cfg.act_dim), generator=torch.Generator().manual_seed(1)) * 2 - 1
    stepped, *_ = logic.step_fused(fresh, a.T, logic.default_params())
    assert ref.spawn_bad(check.ref_state(stepped, "cpu")).all()
    # a spawn moved out of its box, or with a goal outside the right third
    moved = rfresh.replace(goal_pos=rfresh.goal_pos * torch.tensor([[0.5], [1.0], [1.0]]))
    assert ref.spawn_bad(moved).all()
