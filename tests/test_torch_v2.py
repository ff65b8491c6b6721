"""Port's v2 env against the JAX package's, at 8/4 solver iterations, from
the same states (carried across with ``convert``) and the same numpy actions.

* ``reset_fast`` observations of the same spawned states (with their random
  goals): within 1e-4, for v2 and Heavy-v2.
* ``norm_angle``, ``_control`` and ``_score`` alone on the same states.  The
  control's quirks: the spin pump ``w *= 1.1``, the inverted torque sign,
  the ``|vel| < 0.1`` gate, ``10 ** (-agent_dist)`` (XLA's and PyTorch's
  ``pow`` may differ by an ulp: rtol 1e-5).  The score's: the termination
  priority agent-OOB > block-OOB > completion, ``blks_in_place`` held on the
  OOB paths, the completion reward scaled by the agents in contact.
* A 24-step drive through ``VectorEnv`` with ``simple=False,
  anywhere=True`` (agents spawn across the whole width, so some overlap the
  block): obs within 1e-4 and reward within 1e-3 while an env has had no
  contact, done / done_status equal at every step, returns and terminations
  after it.  Heavy-v2 (registered spawn) for 8 steps.
* The registry's v2 kwargs and ``ValueError``s; spawn ranges of both spawn
  branches (the port draws from a ``torch.Generator``, so spawns are
  compared by range and shape, not by value).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gym_puzzles_tpu_torch as gpt
from gym_puzzles_tpu.envs import v2 as jv2
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api import registry as treg
from gym_puzzles_tpu_torch.engine import world as tw
from gym_puzzles_tpu_torch.envs import v2 as tv2
from tests.torch_port_helpers import (assert_trees_close, compare_drive, jax_env, jax_spawns,
                                      np_tree)

torch.set_num_threads(1)

ENV_ID = "MultiRobotPuzzle-v2"
E = 16
W, H = 1440 / 560.0, 810 / 560.0
RATIO = 560.0 / 1440.0


def torch_logic(env_id=ENV_ID, **kw):
    return treg._logic(env_id, "t", 8, 4, None, **kw)


@pytest.mark.parametrize("env_id", [ENV_ID, "MultiRobotPuzzleHeavy-v2"])
def test_reset_fast_obs_of_carried_spawns(env_id):
    jenv = jax_env(env_id, E)
    jstate, jobs = jax_spawns(jenv, 1)
    logic = torch_logic(env_id)
    tstate = convert.state_from_numpy(np_tree(jstate))
    assert tstate.goal_pos.shape == (3, E) and tstate.goal_pos[0].std() > 0  # random goals
    obs = logic.observe(tstate, logic.default_params())
    assert obs.shape == (39, E)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-4, atol=1e-4)
    assert (obs[-1] == np.float32(0.1)).all()  # the scaled-epsilon tail


def test_norm_angle():
    a = np.array([-7.0, -np.pi, -1e-3, 0.0, 1e-3, 1.0, np.pi, 3.2, 2 * np.pi, 9.0], np.float32)
    np.testing.assert_allclose(tv2.norm_angle(torch.as_tensor(a)).numpy(),
                               np.asarray(jv2.norm_angle(jnp.asarray(a))), rtol=1e-6, atol=1e-6)


def test_control_alone():
    jenv = jax_env(ENV_ID, E)
    jlogic, tlogic = jenv.logic, torch_logic()
    jstate, _ = jax_spawns(jenv, 3)
    rng = np.random.RandomState(0)
    B = 7
    # moving, spinning bodies at arbitrary headings
    ang = np.asarray(jstate.bodies.angle).copy()
    ang[5:] = rng.uniform(-7, 7, (2, E))
    jstate = jstate.replace(bodies=jstate.bodies.replace(
        angle=jnp.asarray(ang.astype(np.float32)),
        vel=jnp.asarray(rng.uniform(-1, 1, (B, 2, E)).astype(np.float32)),
        omega=jnp.asarray(rng.uniform(-3, 3, (B, E)).astype(np.float32))))
    tstate = convert.state_from_numpy(np_tree(jstate))
    act = rng.uniform(-1, 1, (4, E)).astype(np.float32)
    act[1, :4] = [0.05, -0.05, 0.0999, 0.1]  # the |vel| < 0.1 gate on agent 0's torque
    act[0, 4:7] = [0.0, 0.5, -0.5]
    jout = jax.vmap(jlogic._control, in_axes=(-1, -1), out_axes=-1)(jstate, jnp.asarray(act))
    tout = tlogic._control(tstate, torch.as_tensor(act))
    assert_trees_close(jout, tout, rtol=1e-5, atol=1e-7)

    bodies, force, torque, wake = tout
    # spin pump: w *= 1.1 on the agents only
    np.testing.assert_allclose(bodies.omega[5:].numpy(), 1.1 * tstate.bodies.omega[5:].numpy(),
                               rtol=1e-6)
    assert torch.equal(bodies.omega[:5], tstate.bodies.omega[:5])
    # no lateral velocity left: v . right = 0
    c, s = torch.cos(tstate.bodies.angle[5:]), torch.sin(tstate.bodies.angle[5:])
    assert (bodies.vel[5:, 0] * c + bodies.vel[5:, 1] * s).abs().max() < 1e-6
    # torque: gated by |vel| < 0.1, sign inverted
    t0 = torque[5].numpy()
    assert (t0[:3] == 0).all() and t0[3] != 0
    assert (np.sign(t0[3:]) == -np.sign(act[0, 3:])).all()
    np.testing.assert_allclose(np.abs(t0[3:]), np.abs(act[0, 3:]) * 0.0005, rtol=1e-6)
    assert not wake[:4].any() and wake[4:].all()


def scored_states(jlogic):
    """Injected v2 states that reach every termination branch: env 0 runs
    on, 1 agent OOB, 2 block OOB, 3 block on its goal, 4 agent OOB with the
    block on its goal, 5 block OOB with an agent OOB too."""
    n = 6
    origin = np.zeros((7, 2, n), np.float32)
    origin[:4] = np.asarray(jlogic.wall_positions, np.float32)[..., None]
    origin[4] = np.array([[W / 2], [H / 2]])
    origin[5] = np.array([[0.5], [0.4]])
    origin[6] = np.array([[0.6], [1.0]])
    goal = np.tile(np.array([[0.8], [0.3], [0.0]], np.float32), (1, n))
    origin[5, 0, [1, 4, 5]] = 0.05  # agent 0 beyond the left bound
    origin[4, 1, [2, 5]] = H - 0.05  # block beyond the top bound
    for e in (3, 4):  # block COM on the goal (the T's COM sits off its origin)
        origin[4, :, e] = goal[:2, e] / RATIO
    angles = np.zeros((7, n), np.float32)
    state = jax.vmap(jlogic.inject, in_axes=(-1, -1, -1), out_axes=-1)(
        jnp.asarray(origin), jnp.asarray(angles), jnp.asarray(goal))
    com_off = np.asarray(state.bodies.pos[4, :, 3]) - origin[4, :, 3]
    for e in (3, 4):
        origin[4, :, e] -= com_off
    state = jax.vmap(jlogic.inject, in_axes=(-1, -1, -1), out_axes=-1)(
        jnp.asarray(origin), jnp.asarray(angles), jnp.asarray(goal))
    gc = np.zeros((2, n), bool)
    gc[0, 3:] = True  # one of two agents in contact: half the completion reward
    return state.replace(
        goal_contact=jnp.asarray(gc),
        blks_in_place=jnp.asarray(np.array([0, 1, 1, 0, 0, 1], np.int32)),
        block_distance=state.block_distance + 0.125,
        agent_dist=state.agent_dist - 0.0625)


def test_score_alone():
    jlogic, tlogic = jax_env(ENV_ID, E).logic, torch_logic()
    jstate = scored_states(jlogic)
    tstate = convert.state_from_numpy(np_tree(jstate))
    jp, tp = jlogic.default_params(), tlogic.default_params()
    jscore = jax.vmap(
        lambda s: jlogic._score(s, s.bodies, s.goal_contact,
                                *jlogic._distances(s.bodies, s.goal_pos), jp),
        in_axes=-1, out_axes=-1)(jstate)
    tscore = tlogic._score(tstate, tstate.bodies, tstate.goal_contact,
                           *tlogic._distances(tstate.bodies, tstate.goal_pos), tp)
    assert_trees_close(jscore, tscore, rtol=1e-5, atol=1e-5)
    obs, reward, done, status, blks = (x.numpy() for x in tscore)
    np.testing.assert_array_equal(status, [0, 1, 2, 3, 1, 1])
    np.testing.assert_array_equal(done, [False, True, True, True, True, True])
    # blks_in_place: recomputed on the running / completion paths, held on OOB
    np.testing.assert_array_equal(blks, [0, 1, 1, 1, 0, 1])
    assert reward[3] > 4000 and reward[3] < 5100  # 10000 * 1/2 agents in contact
    assert reward[1] < -900 and -200 < reward[2] < -50 and reward[4] < -900


def test_24_step_drive_matches_jax():
    compare_drive(ENV_ID, E, 24, 2, return_tol=(1e-4, 1e-3), simple=False, anywhere=True)


def test_heavy_drive_matches_jax():
    compare_drive("MultiRobotPuzzleHeavy-v2", 8, 8, 4, return_tol=(1e-4, 1e-3),
                  need_contact=False)


def test_registry_kwargs():
    env = gpt.make(ENV_ID, num_envs=2, device="cpu", simple=False, anywhere=True)
    assert env.cfg.v2_simple is False and env.cfg.v2_anywhere is True
    assert env.cfg.obs_dim == 39 and env.cfg.act_dim == 4
    assert env.logic.layout.table.num_pairs == 53
    for env_id in ("MultiRobotPuzzle-v0", "MultiRobotPuzzle-v3"):
        with pytest.raises(ValueError, match="v2 spawn-branch capabilities"):
            gpt.make(env_id, num_envs=2, device="cpu", anywhere=True)
    with pytest.raises(ValueError, match="block_shape is a v0/v3 capability"):
        gpt.make(ENV_ID, num_envs=2, device="cpu", block_shape="l")


@pytest.mark.parametrize("simple, anywhere", [(True, False), (False, True)])
def test_spawn_ranges(simple, anywhere):
    n = 256
    env = gpt.make(ENV_ID, num_envs=n, device="cpu", simple=simple, anywhere=anywhere)
    state, obs = env.reset(seed=6)
    assert obs.shape == (n, 39) and torch.isfinite(obs).all()
    lay = env.logic.layout
    origin, _q = tw.body_origins(lay.table, state.bodies)
    blk, agents = origin[4], origin[5:]
    b = 0.3
    tol = 1e-6
    if simple:
        np.testing.assert_allclose(blk[0].numpy(), W / 2, rtol=1e-6)
        np.testing.assert_allclose(blk[1].numpy(), H / 2, rtol=1e-6)
        np.testing.assert_allclose(state.bodies.angle[5:].numpy(), 1.5 * np.pi, rtol=1e-6)
    else:
        assert (blk[0] >= W / 3 + b - tol).all() and (blk[0] <= 2 * W / 3 - b + tol).all()
        assert (blk[1] >= b - tol).all() and (blk[1] <= H - b + tol).all()
        assert blk[0].std() > 0.02 and state.bodies.angle[5:].std() > 0.5
    ax_hi = (W - b) if anywhere else (W / 3 - b)
    assert (agents[:, 0] >= b - tol).all() and (agents[:, 0] <= ax_hi + tol).all()
    assert (agents[:, 1] >= b - tol).all() and (agents[:, 1] <= H - b + tol).all()
    assert bool(agents[:, 0].max() > W / 3) == anywhere
    # goal: the right third, inside its own border (0.4 simple, 0.3 otherwise), normalized
    gb = 0.4 if simple else 0.3
    gx, gy = state.goal_pos[0] / RATIO, state.goal_pos[1] / RATIO
    assert (gx >= 2 * W / 3 + gb - 1e-5).all() and (gx <= W - gb + 1e-5).all()
    assert (gy >= gb - 1e-5).all() and (gy <= H - gb + 1e-5).all()
    assert (state.goal_pos[2] == 0).all() and gx.std() > 0.005
