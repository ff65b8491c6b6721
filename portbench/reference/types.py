"""Engine data model (PyTorch port of ``gym_puzzles_tpu/engine/types.py``).

Two kinds of data, kept strictly apart:

* **Static tables** (:class:`ShapeTable`): per-variant geometry, mass and the
  dense collision pair list.  Built once on the host in numpy, exactly as the
  JAX package builds them (the tests hold the two equal array by array).

* **Dynamic state** (:class:`Bodies`, :class:`Contacts`): tensor dataclasses.
  Every tensor carries the env batch on its **trailing** axis, as the JAX
  package's lane-major layout does: ``Bodies.pos`` is ``[B, 2, E]``.

State convention follows Box2D's sweep: ``pos`` is the **world center of
mass** (``b2Body::GetWorldCenter``), not the body origin; the origin is
derived via the static ``local_center``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from portbench.reference import shapes as shp

MAX_VERTS = shp.MAX_POLYGON_VERTICES


# --------------------------------------------------------------------------
# Build-time specs
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FixtureSpec:
    """One convex fixture, pre-hull.  ``box=`` fixtures keep SetAsBox vertex
    order; free vertex lists go through the hull reorder (shapes.convex_hull),
    both matching what box2d-py stores."""

    vertices: np.ndarray
    density: float = 0.0
    friction: float = 0.2  # Box2D default when unset (e.g. walls, v0 agents)
    restitution: float = 0.0
    from_hull: bool = False  # True for free vertex lists (agent octagons)

    def ordered_vertices(self) -> np.ndarray:
        v = np.asarray(self.vertices, dtype=np.float64)
        return shp.convex_hull(v) if self.from_hull else v


@dataclasses.dataclass
class BodySpec:
    fixtures: Sequence[FixtureSpec]
    static: bool = False
    linear_damping: float = 0.0
    angular_damping: float = 0.0
    name: str = ""


# --------------------------------------------------------------------------
# Static table
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShapeTable:
    """All per-variant constants the engine step needs (numpy arrays)."""

    # body level [B]
    num_bodies: int
    inv_mass: np.ndarray
    inv_inertia: np.ndarray
    mass: np.ndarray
    inertia_com: np.ndarray  # about center of mass (b2Body::m_I)
    local_center: np.ndarray  # [B, 2]
    linear_damping: np.ndarray
    angular_damping: np.ndarray
    is_static: np.ndarray  # bool [B]
    body_names: tuple

    # fixture level [F]
    num_fixtures: int
    fix_body: np.ndarray  # [F] int
    fix_verts: np.ndarray  # [F, MAX_VERTS, 2] padded with last vertex
    fix_normals: np.ndarray  # [F, MAX_VERTS, 2]
    fix_count: np.ndarray  # [F] int
    fix_friction: np.ndarray
    fix_restitution: np.ndarray

    # pair level [P]  (dense: all fixture pairs of distinct bodies, not both static)
    num_pairs: int
    pair_fix_a: np.ndarray
    pair_fix_b: np.ndarray
    pair_body_a: np.ndarray
    pair_body_b: np.ndarray
    pair_friction: np.ndarray  # sqrt(fa*fb), Box2D's default mixer
    pair_restitution: np.ndarray  # max(ra, rb)

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)

    def pairs_between(self, body_a: int, body_b: int) -> np.ndarray:
        """Static mask [P] of pairs connecting the two given bodies."""
        m = ((self.pair_body_a == body_a) & (self.pair_body_b == body_b)) | (
            (self.pair_body_a == body_b) & (self.pair_body_b == body_a)
        )
        return m


def build_shape_table(bodies: Sequence[BodySpec]) -> ShapeTable:
    """Assemble the static table: hulls, normals, mass properties, dense pair
    list.  Mass data reproduces b2Body::ResetMassData including the zero-mass
    fallback (see shapes.body_mass)."""
    B = len(bodies)
    inv_mass = np.zeros(B)
    inv_inertia = np.zeros(B)
    mass = np.zeros(B)
    inertia_com = np.zeros(B)
    local_center = np.zeros((B, 2))
    lin_damp = np.zeros(B)
    ang_damp = np.zeros(B)
    is_static = np.zeros(B, dtype=bool)
    names = []

    fix_body, fix_verts, fix_normals, fix_count = [], [], [], []
    fix_friction, fix_restitution = [], []

    for bi, spec in enumerate(bodies):
        names.append(spec.name or f"body_{bi}")
        is_static[bi] = spec.static
        lin_damp[bi] = spec.linear_damping
        ang_damp[bi] = spec.angular_damping

        ordered = [f.ordered_vertices() for f in spec.fixtures]
        if not spec.static:
            m, c, i_com = shp.body_mass(ordered, [f.density for f in spec.fixtures])
            mass[bi] = m
            local_center[bi] = c
            inertia_com[bi] = i_com
            inv_mass[bi] = 1.0 / m
            inv_inertia[bi] = 1.0 / i_com if i_com > 0.0 else 0.0

        for f, verts in zip(spec.fixtures, ordered):
            n = len(verts)
            if not 3 <= n <= MAX_VERTS:
                raise ValueError(f"fixture has {n} vertices; need 3..{MAX_VERTS}")
            padded = np.concatenate([verts, np.repeat(verts[-1:], MAX_VERTS - n, axis=0)])
            normals = shp.edge_normals(verts)
            padded_n = np.concatenate([normals, np.repeat(normals[-1:], MAX_VERTS - n, axis=0)])
            fix_body.append(bi)
            fix_verts.append(padded)
            fix_normals.append(padded_n)
            fix_count.append(n)
            fix_friction.append(f.friction)
            fix_restitution.append(f.restitution)

    fix_body = np.asarray(fix_body, dtype=np.int32)
    fix_verts = np.asarray(fix_verts, dtype=np.float32)
    fix_normals = np.asarray(fix_normals, dtype=np.float32)
    fix_count = np.asarray(fix_count, dtype=np.int32)
    fix_friction = np.asarray(fix_friction, dtype=np.float32)
    fix_restitution = np.asarray(fix_restitution, dtype=np.float32)

    # Dense pair list: fixtures on distinct bodies, at least one dynamic.
    pa, pb = [], []
    F = len(fix_body)
    for i in range(F):
        for j in range(i + 1, F):
            ba, bb = fix_body[i], fix_body[j]
            if ba == bb:
                continue
            if is_static[ba] and is_static[bb]:
                continue
            pa.append(i)
            pb.append(j)
    pair_fix_a = np.asarray(pa, dtype=np.int32)
    pair_fix_b = np.asarray(pb, dtype=np.int32)

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return ShapeTable(
        num_bodies=B,
        inv_mass=f32(inv_mass),
        inv_inertia=f32(inv_inertia),
        mass=f32(mass),
        inertia_com=f32(inertia_com),
        local_center=f32(local_center),
        linear_damping=f32(lin_damp),
        angular_damping=f32(ang_damp),
        is_static=is_static,
        body_names=tuple(names),
        num_fixtures=F,
        fix_body=fix_body,
        fix_verts=fix_verts,
        fix_normals=fix_normals,
        fix_count=fix_count,
        fix_friction=fix_friction,
        fix_restitution=fix_restitution,
        num_pairs=len(pair_fix_a),
        pair_fix_a=pair_fix_a,
        pair_fix_b=pair_fix_b,
        pair_body_a=fix_body[pair_fix_a] if len(pa) else np.zeros(0, np.int32),
        pair_body_b=fix_body[pair_fix_b] if len(pa) else np.zeros(0, np.int32),
        pair_friction=np.sqrt(fix_friction[pair_fix_a] * fix_friction[pair_fix_b])
        if len(pa)
        else np.zeros(0),
        pair_restitution=np.maximum(fix_restitution[pair_fix_a], fix_restitution[pair_fix_b])
        if len(pa)
        else np.zeros(0),
    )


# --------------------------------------------------------------------------
# Dynamic state (env batch on the trailing axis of every tensor)
# --------------------------------------------------------------------------


class Replaceable:
    """``flax.struct.dataclass``'s ``replace`` for plain dataclasses."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


class DeviceScalars:
    """Marks a dataclass whose fields are all Python floats holding float32
    values (the reward parameters, the learner's hyperparameters).  A CUDA
    graph reads one from a float32 device buffer, a 0-d view per field
    (``utils/cuda_graph.py``), so that a new value reaches the next replay
    without a new capture; code that reads it must accept those views."""


_DEVICE_CONSTS: dict = {}


def device_const(x, device) -> torch.Tensor:
    """``torch.as_tensor(np.asarray(x), device=device)``, made once per
    content and device and then shared: the step path's host constants (the
    static table's columns, layout masks, spawn bounds) are copied to the card
    before a CUDA graph captures the step, which can hold no host-to-device
    copy.  Callers must not write to the tensor."""
    a = np.asarray(x)
    key = (torch.device(device), a.dtype.str, a.shape, a.tobytes())
    t = _DEVICE_CONSTS.get(key)
    if t is None:
        t = _DEVICE_CONSTS[key] = torch.tensor(a, device=device)
    return t


@dataclasses.dataclass
class Bodies(Replaceable):
    """Per-env rigid body state.  ``pos`` is the world COM (sweep center).

    ``awake``/``sleep_time`` model Box2D sleeping, which is active in the
    reference despite doSleep=False (box2d-py 2.3.5 ignores the flag)."""

    pos: torch.Tensor  # [B, 2, E] f32
    angle: torch.Tensor  # [B, E] f32
    vel: torch.Tensor  # [B, 2, E] f32
    omega: torch.Tensor  # [B, E] f32
    awake: torch.Tensor  # [B, E] bool
    sleep_time: torch.Tensor  # [B, E] f32


@dataclasses.dataclass
class Contacts(Replaceable):
    """Per-pair persistent contact state: the stored manifold (for warm
    starting, id matching and stale reuse while both bodies sleep), the
    accumulated impulses, and the touching flag driving Begin/EndContact."""

    man: object  # narrowphase.Manifold with [P, ..., E] tensors
    normal_impulse: torch.Tensor  # [P, 2, E] f32
    tangent_impulse: torch.Tensor  # [P, 2, E] f32
    touching: torch.Tensor  # [P, E] bool
