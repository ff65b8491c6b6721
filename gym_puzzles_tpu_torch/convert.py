"""Carry state across between the JAX package and the port.

The JAX package's ``EnvState`` (a tree of flax dataclasses) goes across as
nested dicts of numpy arrays, keyed by field name, with the env batch on the
last axis of every array -- the layout of ``VectorEnv(batch_axis=-1)`` on
both sides.  This module needs neither JAX nor the JAX package: the caller
turns the JAX tree into dicts (its fields are dataclass fields).

The contact solve's inputs go across the same way
(:func:`constraints_from_numpy`, :func:`manifold_from_numpy`), so both
packages' ``solve_contacts`` can be given the same constraints.

JAX PRNG keys are not carried: the port's ``VectorEnv`` owns a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_puzzles_tpu_torch.engine.narrowphase import Manifold
from gym_puzzles_tpu_torch.engine.solver import VelocityConstraints
from gym_puzzles_tpu_torch.engine.types import Bodies, Contacts, ShapeTable
from gym_puzzles_tpu_torch.envs.common import EnvState

# dataclass-valued fields of the state tree
_NESTED = {
    (EnvState, "bodies"): Bodies,
    (EnvState, "contacts"): Contacts,
    (Contacts, "man"): Manifold,
}


def from_numpy(cls, tree, device=None):
    """A state dataclass ``cls`` (EnvState, Bodies, Contacts, Manifold) from
    nested dicts of numpy arrays keyed by field name, keeping each dtype."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        sub = _NESTED.get((cls, f.name))
        value = tree[f.name]
        kwargs[f.name] = (from_numpy(sub, value, device) if sub is not None
                          else torch.as_tensor(np.array(value), device=device))
    return cls(**kwargs)


def state_from_numpy(tree, device=None) -> EnvState:
    """The port's EnvState from nested dicts of numpy arrays (bodies,
    contacts with their manifold, flags, distances, goal_pos, t,
    done_status), keeping each array's dtype."""
    return from_numpy(EnvState, tree, device)


def constraints_from_numpy(tree, device=None) -> VelocityConstraints:
    """The port's VelocityConstraints from a dict of numpy arrays keyed by
    field name, env axis last ([P, ..., E])."""
    return from_numpy(VelocityConstraints, tree, device)


def manifold_from_numpy(tree, device=None) -> Manifold:
    """The port's Manifold from a dict of numpy arrays, env axis last."""
    return from_numpy(Manifold, tree, device)


def state_to_numpy(state) -> dict:
    """Inverse of :func:`state_from_numpy`: nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(state):
        return {f.name: state_to_numpy(getattr(state, f.name))
                for f in dataclasses.fields(state)}
    return state.detach().cpu().numpy()


def shape_table_to_numpy(table: ShapeTable) -> dict:
    """Every field of a static table as a numpy array (counts as 0-d)."""
    return {f.name: np.asarray(getattr(table, f.name)) for f in dataclasses.fields(table)}
