"""Port's v3 env against the JAX package's, at 8/4 solver iterations, from
the same states (carried across with ``convert``) and the same numpy actions.

* ``reset_fast`` observations of the same spawned states: within 1e-4
  (normalized units), for the registered env and for ``num_agents=3`` and
  ``5``, ``heavy=True``.
* ``_control`` and ``_score`` alone on the same states: floats within
  rtol 1e-5 / atol 1e-6, flags and counters equal; the completion branch is
  reached by injecting the block onto the goal.
* A 40-step drive through ``VectorEnv``: obs within 1e-4 and reward within
  1e-3 while an env has had no contact, done / done_status equal at every
  step, returns (rtol 1e-4, atol 1e-3) and terminations after it.  The
  heavy world with 3 and with 5 agents for 15 steps.
* The registry's v3 constructor surface and its ``ValueError``s; spawn
  ranges (the port draws from a ``torch.Generator``, so spawns are compared
  by range and shape, not by value).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gym_puzzles_tpu_torch as gpt
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api import registry as treg
from gym_puzzles_tpu_torch.engine import world as tw
from tests.torch_port_helpers import (assert_trees_close, compare_drive, jax_env, jax_spawns,
                                      np_tree)

torch.set_num_threads(1)

ENV_ID = "MultiRobotPuzzle-v3"
E = 16
HEAVY3 = dict(num_agents=3, heavy=True)
HEAVY5 = dict(num_agents=5, heavy=True)


def torch_logic(**kw):
    return treg._logic(ENV_ID, "t", 8, 4, None, **kw)


@pytest.mark.parametrize("kw", [{}, HEAVY3, HEAVY5],
                         ids=["registered", "3-agents-heavy", "5-agents-heavy"])
def test_reset_fast_obs_of_carried_spawns(kw):
    jenv = jax_env(ENV_ID, E, **kw)
    jstate, jobs = jax_spawns(jenv, 1)
    logic = torch_logic(**kw)
    assert logic.cfg.obs_dim == jenv.cfg.obs_dim == 4 * logic.cfg.num_agents + 19
    assert logic.cfg.act_dim == jenv.cfg.act_dim == 3 * logic.cfg.num_agents
    obs = logic.observe(convert.state_from_numpy(np_tree(jstate)), logic.default_params())
    assert obs.shape == (logic.cfg.obs_dim, E)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-4, atol=1e-4)


def test_control_and_score_alone():
    jenv = jax_env(ENV_ID, E)
    jlogic, tlogic = jenv.logic, torch_logic()
    jstate, _ = jax_spawns(jenv, 3)
    # put the block of the first four envs onto the goal: the completion branch
    origin, _q = tw.body_origins(tlogic.layout.table,
                                 convert.state_from_numpy(np_tree(jstate)).bodies)
    origin = origin.numpy().copy()
    gx = tlogic.goal_px[0] / 30.0
    origin[tlogic.layout.block_slot, :, :4] = np.array([[gx], [8.0]])
    angles = np.asarray(jstate.bodies.angle)
    jstate = jax.vmap(jlogic.inject, in_axes=(-1, -1, None), out_axes=-1)(
        jnp.asarray(origin), jnp.asarray(angles), jnp.asarray(jlogic.goal_norm))
    gc = np.zeros((2, E), bool)
    gc[0, ::2], gc[1, ::3] = True, True
    jstate = jstate.replace(goal_contact=jnp.asarray(gc),
                            block_distance=jstate.block_distance + 0.125)
    tstate = convert.state_from_numpy(np_tree(jstate))

    act = np.random.RandomState(0).uniform(-1, 1, (6, E)).astype(np.float32)
    act[:, 5] = 0.0  # an env whose agents are not woken
    jout = jax.vmap(jlogic._control, in_axes=(-1, -1), out_axes=-1)(jstate, jnp.asarray(act))
    tout = tlogic._control(tstate, torch.as_tensor(act))
    assert_trees_close(jout, tout)
    assert not tout[3][5:, 5].any() and tout[3][4].all()

    jp, tp = jlogic.default_params(), tlogic.default_params()
    # the state's stored distances were shifted above, so the delta terms count
    jscore = jax.vmap(
        lambda s: jlogic._score(s, s.bodies, s.goal_contact,
                                *jlogic._distances(s.bodies, s.goal_pos), jp),
        in_axes=-1, out_axes=-1)(jstate)
    tscore = tlogic._score(tstate, tstate.bodies, tstate.goal_contact,
                           *tlogic._distances(tstate.bodies, tstate.goal_pos), tp)
    assert_trees_close(jscore, tscore, rtol=1e-5, atol=1e-5)
    done, status = tscore[2].numpy(), tscore[3].numpy()
    assert done[:4].all() and (status[:4] == 3).all() and not done[4:].all()
    assert (tscore[1][:4] > 99.0).all()  # the unshaped completion reward, +100


def test_40_step_drive_matches_jax():
    compare_drive(ENV_ID, E, 40, 2, return_tol=(1e-4, 1e-3))


@pytest.mark.parametrize("num_agents", [3, 5])
def test_heavy_three_agent_drive_matches_jax(num_agents):
    """The heavy world with three agents, and with five (48 pairs: the large
    size class of the port's kernels), whose eight spawns are all in contact
    from the first step: for it the returns and terminations are compared
    (its spawns' obs: ``test_reset_fast_obs_of_carried_spawns``)."""
    env, state = compare_drive(ENV_ID, 8, 15, 4, return_tol=(1e-4, 1e-3), need_contact=False,
                               need_free=num_agents == 3, num_agents=num_agents, heavy=True)
    assert env.logic.layout.table.num_bodies == 5 + num_agents
    assert state.goal_contact.shape == (num_agents, 8)


def test_registry_constructor_surface():
    heavy5 = gpt.make(ENV_ID, num_envs=2, device="cpu", num_agents=5, heavy=True)
    assert heavy5.cfg.obs_dim == 39 and heavy5.cfg.act_dim == 15
    assert heavy5.logic.layout.table.num_pairs == 48
    with pytest.raises(ValueError, match="num_agents must be >= 1"):
        gpt.make(ENV_ID, num_envs=2, device="cpu", num_agents=0)
    for env_id in ("MultiRobotPuzzle-v0", "MultiRobotPuzzle-v2"):
        with pytest.raises(ValueError, match="v3 constructor capabilities"):
            gpt.make(env_id, num_envs=2, device="cpu", num_agents=3)
        with pytest.raises(ValueError, match="v3 constructor capabilities"):
            gpt.make(env_id, num_envs=2, device="cpu", heavy=True)
    with pytest.raises(ValueError, match="v2 spawn-branch capabilities"):
        gpt.make(ENV_ID, num_envs=2, device="cpu", simple=False)
    # accepted and ignored, as in the reference
    env = gpt.make(ENV_ID, num_envs=2, device="cpu", goal_velocity=1.0, block_density=2.0,
                   hardmode=True, block_shape="l")
    assert env.cfg.obs_dim == 27 - 2


def test_world_beyond_the_kernels_tables_is_refused():
    from gym_puzzles_tpu_torch.engine import _cuda_build as cb

    logic = torch_logic(num_agents=12)
    assert logic.layout.table.num_bodies == 17
    with pytest.raises(ValueError, match="at most"):
        cb.world_struct(logic.layout.table)


def test_spawn_ranges_and_autoreset():
    env = gpt.make(ENV_ID, num_envs=64, device="cpu", max_episode_steps=3, **{
        "velocity_iters": 4, "position_iters": 2})
    state, obs = env.reset(seed=5)
    assert obs.shape == (64, 27) and torch.isfinite(obs).all()
    lay = env.logic.layout
    origin, _q = tw.body_origins(lay.table, state.bodies)
    w, h, b = lay.world_w, lay.world_h, 1.0
    blk, agents = origin[lay.block_slot], origin[lay.block_slot + 1:]
    assert (blk[0] >= w / 3 + 2 * b).all() and (blk[0] <= 2 * w / 3 - 2 * b).all()
    assert (blk[1] >= 3 * b).all() and (blk[1] <= h - 3 * b).all()
    assert (agents[:, 0] >= b).all() and (agents[:, 0] <= w / 3 - 2 * b).all()
    assert (agents[:, 1] >= b).all() and (agents[:, 1] <= h - b).all()
    assert blk[0].std() > 0.1 and state.bodies.angle[lay.block_slot].std() > 0.5
    np.testing.assert_allclose(state.goal_pos[:, 0].numpy(), env.logic.goal_norm)
    for k in range(3):
        state, obs, reward, done, info = env.step(state, torch.zeros(64, 6))
    assert done.all() and (state.t == 0).all() and info["truncated"].all()
