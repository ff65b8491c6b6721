"""Shared helpers of the port's engine tests (tests/test_torch_engine*.py):
the same worlds built by both packages, and one tick of each on the same
states."""


import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gym_puzzles_tpu.api.registry import _logic as jax_logic
from gym_puzzles_tpu.engine import shapes as jshp
from gym_puzzles_tpu.engine import types as jtypes
from gym_puzzles_tpu.engine import world as jw
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api.registry import _logic as torch_logic
from gym_puzzles_tpu_torch.engine import shapes as tshp
from gym_puzzles_tpu_torch.engine import types as ttypes
from gym_puzzles_tpu_torch.engine import world as tw

DT = 1.0 / 50.0
T_BOXES = [(0.5, 0.5, 0.0, -0.5), (1.5, 0.5, 0.0, 0.5)]
AGENT_POLY = [(-0.25, -0.75), (0.25, -0.75), (0.75, -0.25), (0.75, 0.25),
              (0.25, 0.75), (-0.25, 0.75), (-0.75, 0.25), (-0.75, -0.25)]


def np_tree(x):
    """JAX dataclass tree -> nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: np_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def small_tables():
    """T-block + two octagon agents, built by both packages."""
    def build(shp, types):
        blk = types.BodySpec(
            fixtures=[types.FixtureSpec(vertices=shp.box_vertices(hx, hy, (cx, cy)),
                                        density=5.0, friction=0.999)
                      for hx, hy, cx, cy in T_BOXES],
            linear_damping=5.0, angular_damping=5.0)
        ag = lambda: types.BodySpec(
            fixtures=[types.FixtureSpec(vertices=np.array(AGENT_POLY), density=0.0,
                                        friction=0.2, from_hull=True)],
            linear_damping=5.0, angular_damping=5.0)
        return types.build_shape_table([blk, ag(), ag()])

    return build(jshp, jtypes), build(tshp, ttypes)


@functools.lru_cache(maxsize=None)
def jax_step(table, vi, pi):
    return jax.jit(jax.vmap(
        lambda b, c, f, t, w: jw.step(table, b, c, f, t, w, DT, vi, pi),
        in_axes=-1, out_axes=-1))


@functools.lru_cache(maxsize=None)
def v0_tables():
    return jax_logic("MultiRobotPuzzle-v0").layout.table, \
        torch_logic("MultiRobotPuzzle-v0").layout.table


def both_init(jt, tt, origin, angle):
    """Bodies (and empty contacts) from origin poses [B, 2, E] in both packages."""
    E = origin.shape[-1]
    jb = jax.vmap(lambda o, a: jw.init_bodies(jt, o, a), in_axes=-1, out_axes=-1)(
        jnp.asarray(origin), jnp.asarray(angle))
    jc = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x[..., None], x.shape + (E,)),
                                jw.init_contacts(jt))
    tb = convert.from_numpy(ttypes.Bodies, np_tree(jb))
    tc = tw.init_contacts(tt, E)
    return jb, jc, tb, tc


def step_both(jt, tt, jb, jc, tb, tc, force, torque, wake, vi, pi):
    jr = jax_step(jt, vi, pi)(jb, jc, jnp.asarray(force), jnp.asarray(torque), jnp.asarray(wake))
    tr = tw.step(tt, tb, tc, torch.tensor(np.array(force)), torch.tensor(np.array(torque)),
                 torch.tensor(np.array(wake)), DT, vi, pi)
    return jr, tr


def maxdiff(j, t):
    return float(np.abs(np.asarray(j, np.float64) - t.numpy()).max())


