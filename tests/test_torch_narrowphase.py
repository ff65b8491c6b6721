"""Port's narrow phase against the JAX package's: ``collide_polygons`` on
random box / octagon poses and ``match_impulses`` on random ids, the same
numpy inputs through both.  Ids, counts and flips exact; alive points,
normals and plane points within 1e-5 (XLA on the CPU contracts a*b+c into
FMA, PyTorch rounds each product)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_puzzles_tpu.engine import narrowphase as jnph
from gym_puzzles_tpu_torch.engine import narrowphase as tnph
from gym_puzzles_tpu_torch.engine import shapes as shp
from gym_puzzles_tpu_torch.engine.types import FixtureSpec

torch.set_num_threads(1)

V = shp.MAX_POLYGON_VERTICES
OCTAGON = [(-0.25, -0.75), (0.25, -0.75), (0.75, -0.25), (0.75, 0.25),
           (0.25, 0.75), (-0.25, 0.75), (-0.75, 0.25), (-0.75, -0.25)]


def _poly(kind):
    """Padded (verts [V,2], normals [V,2], count) of a box or the v0 agent."""
    if kind == "box":
        verts = shp.box_vertices(1.5, 0.5, (0.0, 0.5))
    else:
        verts = FixtureSpec(vertices=np.array(OCTAGON), from_hull=True).ordered_vertices()
    n = len(verts)
    normals = shp.edge_normals(verts)
    pad = lambda a: np.concatenate([a, np.repeat(a[-1:], V - n, axis=0)]).astype(np.float32)
    return pad(verts), pad(normals), n


@pytest.mark.parametrize("kind_a, kind_b", [("box", "oct"), ("oct", "oct"), ("box", "box")])
def test_collide_polygons_matches_jax(kind_a, kind_b):
    rng = np.random.RandomState(7)
    N = 400
    va, na, ca = _poly(kind_a)
    vb, nb, cb = _poly(kind_b)
    pos_a = rng.uniform(-0.3, 0.3, (N, 2)).astype(np.float32)
    pos_b = (pos_a + rng.uniform(-2.2, 2.2, (N, 2))).astype(np.float32)
    ang_a = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    rot = lambda a: np.stack([np.cos(a), np.sin(a)], -1).astype(np.float32)

    def tile(x):
        return np.broadcast_to(x, (N,) + x.shape)

    jm = jax.jit(jax.vmap(jnph.collide_polygons))(
        tile(va), tile(na), np.full(N, ca, np.int32), pos_a, rot(ang_a),
        tile(vb), tile(nb), np.full(N, cb, np.int32), pos_b, rot(ang_b))
    t = torch.as_tensor
    tm = tnph.collide_polygons(
        t(va), t(na), t(np.int32(ca)), t(pos_a), t(rot(ang_a)),
        t(vb), t(nb), t(np.int32(cb)), t(pos_b), t(rot(ang_b)))

    count = np.asarray(jm.count)
    assert 50 < (count > 0).sum() < N, "poses should mix touching and separated pairs"
    np.testing.assert_array_equal(tm.count.numpy(), count)
    np.testing.assert_array_equal(tm.ids.numpy(), np.asarray(jm.ids))
    np.testing.assert_array_equal(tm.flip.numpy(), np.asarray(jm.flip))
    np.testing.assert_allclose(tm.local_normal.numpy(), np.asarray(jm.local_normal), atol=1e-5)
    np.testing.assert_allclose(tm.local_point.numpy(), np.asarray(jm.local_point), atol=1e-5)
    alive = np.arange(2)[None, :] < count[:, None]
    np.testing.assert_allclose(tm.points.numpy()[alive], np.asarray(jm.points)[alive], atol=1e-5)


def test_match_impulses_matches_jax():
    rng = np.random.RandomState(3)
    N = 2000
    new_ids = rng.choice([-1, 0x10000, 0x10001, 0x1000101, 0x100], (N, 2)).astype(np.int32)
    old_ids = rng.choice([-1, 0x10000, 0x10001, 0x1000101, 0x100], (N, 2)).astype(np.int32)
    on = rng.uniform(0, 2, (N, 2)).astype(np.float32)
    ot = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    jn, jt = jax.vmap(jnph.match_impulses)(new_ids, old_ids, on, ot)
    tn, tt = tnph.match_impulses(*(torch.as_tensor(x) for x in (new_ids, old_ids, on, ot)))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # packed-id helpers agree bit for bit
    ids = torch.as_tensor(old_ids)
    np.testing.assert_array_equal(tnph.flip_id(ids).numpy(), np.asarray(jnph.flip_id(jnp.asarray(old_ids))))
