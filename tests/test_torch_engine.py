"""Port's plain engine tick (``world.step``, batched on the trailing env axis)
against ``jax.vmap(world.step)`` of the JAX package at the reference's 180/60
iterations, on the same states:

1. free motion, 1 tick: pos/vel <= 1e-5, angle <= 1e-6;
2. v0 random spawns, 1 tick: columns with no contact <= 1e-4, median <= 1e-3
   (tests/test_pallas.py:42-51), awake exact.

XLA on the CPU contracts a*b+c into FMA where PyTorch rounds each product,
so the two differ in the last bits; the solver amplifies that in contact.
The contact scenarios at 8/4 are in tests/test_torch_engine_contact.py.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gym_puzzles_tpu.api.registry import _logic as jax_logic
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.engine import types as ttypes
from tests.torch_port_helpers import both_init, maxdiff, np_tree, step_both, v0_tables

torch.set_num_threads(1)


def test_free_motion_one_tick_180_60():
    jt, tt = v0_tables()
    E = 8
    rng = np.random.RandomState(0)
    origin = np.array([[0.0, 8.0], [21.33, 8.0], [10.67, 0.0], [10.67, 16.0],
                       [10.0, 8.0], [4.0, 4.0], [16.0, 12.0]], np.float32)
    origin = np.repeat(origin[..., None], E, -1)
    angle = np.zeros((7, E), np.float32)
    angle[4] = rng.uniform(-np.pi, np.pi, E)
    jb, jc, tb, tc = both_init(jt, tt, origin, angle)
    vel = np.zeros((7, 2, E), np.float32)
    vel[4:] = rng.uniform(-1.5, 1.5, (3, 2, E))
    omega = np.zeros((7, E), np.float32)
    omega[4:] = rng.uniform(-2, 2, (3, E))
    jb = jb.replace(vel=jnp.asarray(vel), omega=jnp.asarray(omega))
    tb = tb.replace(vel=torch.as_tensor(vel), omega=torch.as_tensor(omega))
    force = np.zeros((7, 2, E), np.float32)
    force[4] = rng.uniform(-2, 2, (2, E))
    torque = np.zeros((7, E), np.float32)
    wake = np.zeros((7, E), bool)
    wake[4:] = True

    (jb2, jc2, _), (tb2, tc2, _) = step_both(jt, tt, jb, jc, tb, tc, force, torque, wake,
                                             180, 60)
    assert not np.asarray(jc2.touching).any(), "scenario must stay contact-free"
    assert maxdiff(jb2.pos, tb2.pos) <= 1e-5
    assert maxdiff(jb2.vel, tb2.vel) <= 1e-5
    assert maxdiff(jb2.angle, tb2.angle) <= 1e-6
    assert maxdiff(jb2.omega, tb2.omega) <= 1e-5
    np.testing.assert_array_equal(tb2.awake.numpy(), np.asarray(jb2.awake))


def test_v0_random_spawns_one_tick_180_60():
    jl = jax_logic("MultiRobotPuzzle-v0")
    jt, tt = v0_tables()
    E = 16
    keys = jax.random.split(jax.random.key(11), E)
    state, _ = jax.jit(jax.vmap(jl.reset_fast, in_axes=(0, None), out_axes=-1))(
        keys, jl.default_params())
    a = np.random.RandomState(5).uniform(-1, 1, (jl.cfg.act_dim, E)).astype(np.float32)
    jb, force, torque, wake = jax.vmap(jl._control, in_axes=(-1, -1), out_axes=-1)(
        state, jnp.asarray(a))
    tb = convert.from_numpy(ttypes.Bodies, np_tree(jb))
    tc = convert.from_numpy(ttypes.Contacts, np_tree(state.contacts))
    (jb2, jc2, _), (tb2, tc2, _) = step_both(
        jt, tt, jb, state.contacts, tb, tc, np.asarray(force), np.asarray(torque),
        np.asarray(wake), 180, 60)

    d = np.abs(np.asarray(jb2.pos) - tb2.pos.numpy()).max(axis=(0, 1))
    touch = np.asarray(jc2.touching).any(axis=0)
    assert (~touch).any() and touch.any(), "spawns should mix contact and free envs"
    np.testing.assert_array_less(d[~touch], 1e-4)
    assert np.median(d) <= 1e-3
    np.testing.assert_array_equal(tb2.awake.numpy(), np.asarray(jb2.awake))
