"""Port's v0 env and ``VectorEnv`` against the JAX package's
``VectorEnv(backend='xla')``, at 8/4 solver iterations, from the same
spawned states (carried across with ``convert``) and the same numpy actions.

* ``reset_fast`` observations of the same spawned states: rtol 1e-4.
* A 50-step drive: while an env has had no contact, obs (pixel units) within
  rtol 1e-4 and reward within 1e-3 (measured 2.3e-4: the reward scales
  distance deltas by 12.5, so last-bit state differences show); done and
  done_status equal throughout.  Past the first contact f32 chaos can make
  states diverge (docs/PARITY.md:94-99), so there the 50-step returns
  (measured within 7e-7 relative at 8/4; held to 1e-4) and the
  terminations are compared.
* Autoreset at ``max_episode_steps=5``, and ``reset_mode='reference'``.
"""

import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gym_puzzles_tpu.api import registry as jreg
from gym_puzzles_tpu.api.vector import VectorState
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api import registry as treg
from gym_puzzles_tpu_torch.engine import world as tw
from tests.torch_port_helpers import np_tree

torch.set_num_threads(1)

ENV_ID = "MultiRobotPuzzle-v0"
E = 16
ITERS = dict(velocity_iters=8, position_iters=4)


def jax_tree(template, tree):
    """nested numpy dicts -> a JAX dataclass tree shaped like ``template``."""
    if dataclasses.is_dataclass(template):
        return type(template)(**{f.name: jax_tree(getattr(template, f.name), tree[f.name])
                                 for f in dataclasses.fields(template)})
    return jnp.asarray(tree)


@functools.lru_cache(maxsize=None)
def jax_env():
    return jreg.make(ENV_ID, num_envs=E, auto_reset=False, **ITERS)


def jax_spawns(seed):
    """(EnvState with trailing env axis, obs [obs_dim, E]) from JAX reset_fast."""
    logic = jax_env().logic
    keys = jax.random.split(jax.random.key(seed), E)
    return jax.jit(jax.vmap(logic.reset_fast, in_axes=(0, None), out_axes=-1))(
        keys, logic.default_params())


def jax_step(state, action):
    vs = VectorState(env=state, key=jax.random.split(jax.random.key(0), E))
    vs, obs, reward, done, info = jax_env().step(vs, jnp.asarray(action))
    return vs.env, np.asarray(obs), np.asarray(reward), np.asarray(done), info


def test_reset_fast_obs_of_carried_spawns():
    jstate, jobs = jax_spawns(1)
    logic = treg._logic(ENV_ID, "t", 8, 4, None)
    obs = logic.observe(convert.state_from_numpy(np_tree(jstate)), logic.default_params())
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-4, atol=1e-4)
    # the carried state comes back out unchanged
    back = convert.state_to_numpy(convert.state_from_numpy(np_tree(jstate)))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, np_tree(jstate))


def test_50_step_drive_matches_jax():
    jstate, _ = jax_spawns(2)
    env = treg.make(ENV_ID, num_envs=E, auto_reset=False, device="cpu", **ITERS)
    tstate = convert.state_from_numpy(np_tree(jstate))
    rng = np.random.RandomState(0)
    contacted = np.zeros(E, bool)
    ret_j = np.zeros(E)
    ret_t = np.zeros(E)
    for _ in range(50):
        a = rng.uniform(-1, 1, (E, env.cfg.act_dim)).astype(np.float32)
        jstate, jobs, jrew, jdone, jinfo = jax_step(jstate, a)
        tstate, tobs, trew, tdone, tinfo = env.step(tstate, torch.as_tensor(a))
        contacted |= np.asarray(jstate.contacts.touching).any(axis=0)
        contacted |= tstate.contacts.touching.any(dim=0).numpy()
        free = ~contacted
        np.testing.assert_allclose(tobs.numpy()[free], jobs[free], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(trew.numpy()[free], jrew[free], atol=1e-3)
        np.testing.assert_array_equal(tdone.numpy(), jdone)
        np.testing.assert_array_equal(tinfo["done_status"].numpy(),
                                      np.asarray(jinfo["done_status"]))
        ret_j += jrew
        ret_t += trew.numpy()
    assert contacted.any() and not contacted.all(), "drive should mix free and contact envs"
    # past the first contact: returns, not states
    np.testing.assert_allclose(ret_t, ret_j, rtol=1e-4, atol=1e-2)


def test_autoreset_at_max_episode_steps():
    env = treg.make(ENV_ID, num_envs=8, device="cpu", max_episode_steps=5, **ITERS)
    state, obs = env.reset(seed=3)
    assert obs.shape == (8, env.cfg.obs_dim) and torch.isfinite(obs).all()
    before = state.bodies.pos.clone()
    zero = torch.zeros(8, env.cfg.act_dim)
    for k in range(5):
        state, obs, reward, done, info = env.step(state, zero)
        assert bool(done.all()) == (k == 4)
    assert info["truncated"].all() and (info["t"] == 5).all()
    # reset envs: clock at 0, fresh contacts, new spawns inside the borders
    assert (state.t == 0).all() and not state.contacts.touching.any()
    assert not torch.equal(state.bodies.pos, before)
    origin, _q = tw.body_origins(env.logic.layout.table, state.bodies)
    lay = env.logic.layout
    movable = origin[lay.block_slot:]
    assert (movable[:, 0] >= 1.0).all() and (movable[:, 0] <= lay.world_w - 1.0).all()
    assert (movable[:, 1] >= 1.0).all() and (movable[:, 1] <= lay.world_h - 1.0).all()
    torch.testing.assert_close(obs.T, env.logic.observe(state, env.default_params()))


def test_reset_mode_reference():
    """Reference-mode reset = spawn + one uniform random action stepped
    through the env, clock left at 0.  The port's spawn and action, carried
    to the JAX package and stepped there, give the same observation."""
    env = treg.make(ENV_ID, num_envs=E, auto_reset=False, reset_mode="reference",
                    device="cpu", **ITERS)
    state, obs = env.reset(seed=4)
    assert (state.t == 0).all()
    spawn, act = env.logic.reset_spawn(torch.Generator().manual_seed(4), E)

    template, _ = jax_spawns(0)
    jstate = jax_tree(template, convert.state_to_numpy(spawn))
    jstate, jobs, _r, _d, _i = jax_step(jstate, act.T.numpy())
    free = ~np.asarray(jstate.contacts.touching).any(axis=0)
    assert free.any()
    np.testing.assert_allclose(obs.numpy()[free], jobs[free], rtol=1e-4, atol=1e-3)
    d = np.abs(obs.numpy() - jobs).max(axis=1)
    assert np.median(d) <= 1e-2  # pixel units
