"""Convex polygon narrow phase: SAT + incident-edge clipping -> 2-point
manifolds with Box2D-compatible contact feature ids.

PyTorch port of ``gym_puzzles_tpu/engine/narrowphase.py``.  Where the JAX
functions take one pair and are vmapped, these take any leading batch shape
``S`` (broadcastable across arguments): vertices ``[*S, V, 2]``, counts
``[*S]``, positions and rotations ``[*S, 2]``.  The rules are
``b2CollidePolygons``'s: reference-edge selection with the 0.1*linearSlop
bias, incident-edge argmin (first minimum wins), two side-plane clips that
fail the whole manifold when fewer than 2 points survive, and the final
separation <= totalRadius filter with slot compaction.  Padded vertices
(repeating the last vertex) are masked out of every argmin / argmax / min.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import math2d as m2
from portbench.reference.shapes import LINEAR_SLOP, MAX_POLYGON_VERTICES, POLYGON_RADIUS
from portbench.reference.types import Replaceable

TOTAL_RADIUS = 2.0 * POLYGON_RADIUS
CLIP_TOL = 0.1 * LINEAR_SLOP

# b2ContactFeature types
_VERTEX = 0
_FACE = 1


def make_id(index_a, index_b, type_a: int, type_b: int):
    """Pack a b2ContactID: indexA | indexB<<8 | typeA<<16 | typeB<<24."""
    return (
        index_a.to(torch.int32)
        | (index_b.to(torch.int32) << 8)
        | (type_a << 16)
        | (type_b << 24)
    )


def flip_id(cid):
    """Swap the A/B halves of a packed contact id (b2ContactID swap)."""
    index_a = cid & 0xFF
    index_b = (cid >> 8) & 0xFF
    type_a = (cid >> 16) & 0xFF
    type_b = (cid >> 24) & 0xFF
    return index_b | (index_a << 8) | (type_b << 16) | (type_a << 24)


@dataclasses.dataclass
class Manifold(Replaceable):
    """Fixed-shape contact manifold.

    ``flip`` False => reference face on fixture A (b2Manifold::e_faceA);
    True => reference on B.  ``local_normal`` / ``local_point`` live in the
    reference body frame, ``points`` in the incident body frame, exactly as
    b2Manifold stores them.  Shapes as returned by :func:`collide_polygons`:
    flip ``[*S]``, local_normal/local_point ``[*S, 2]``, points ``[*S, 2, 2]``,
    ids ``[*S, 2]`` int32, count ``[*S]`` int32.  In engine state the env
    axis moves last (see ``world.collide_all``).
    """

    flip: torch.Tensor
    local_normal: torch.Tensor
    local_point: torch.Tensor
    points: torch.Tensor
    ids: torch.Tensor
    count: torch.Tensor


def _vert_mask(count):
    """[*S, V] mask of real (unpadded) vertices."""
    return torch.arange(MAX_POLYGON_VERTICES, device=count.device) < count[..., None]


def _take(rows, idx):
    """rows[..., idx, :] for rows [*S, V, 2] and idx [*S]."""
    shape = torch.broadcast_shapes(rows.shape[:-2], idx.shape)
    rows = rows.expand(shape + rows.shape[-2:])
    ix = idx.long().expand(shape)[..., None, None].expand(shape + (1, 2))
    return torch.gather(rows, -2, ix).squeeze(-2)


def _max_separation(verts1, normals1, count1, p1, q1, verts2, count2, p2, q2):
    """b2FindMaxSeparation: best separating edge of poly1 against poly2.

    Returns (separation, edge_index); the first maximum wins ties, matching
    the C++ scan order.
    """
    q = m2.rot_mul_t(q2, q1)  # poly1 frame -> poly2 frame rotation
    p = m2.rot_vec_t(q2, p1 - p2)

    n = m2.rot_vec(q[..., None, :], normals1)  # [*S, V, 2] poly1 normals in poly2 frame
    v1 = m2.rot_vec(q[..., None, :], verts1) + p[..., None, :]

    # s_i = min_j dot(n_i, verts2_j - v1_i)
    d = (
        n[..., :, 0, None] * verts2[..., None, :, 0]
        + n[..., :, 1, None] * verts2[..., None, :, 1]
    )  # [*S, V, V]: dot(n_i, verts2_j)
    d = torch.where(_vert_mask(count2)[..., None, :], d, torch.inf)
    s = d.amin(dim=-1) - m2.dot(n, v1)
    s = torch.where(_vert_mask(count1), s, -torch.inf)
    best = torch.argmax(s, dim=-1)
    return s.amax(dim=-1), best.to(torch.int32)


def _incident_edge(normals1, edge1, q1, verts2, normals2, count2, p2, q2):
    """b2FindIncidentEdge: endpoints (world) and indices of poly2's edge most
    anti-parallel to poly1's reference edge."""
    normal1 = m2.rot_vec_t(q2, m2.rot_vec(q1, _take(normals1, edge1)))  # in poly2 frame
    dots = normals2[..., 0] * normal1[..., None, 0] + normals2[..., 1] * normal1[..., None, 1]
    dots = torch.where(_vert_mask(count2), dots, torch.inf)
    i1 = torch.argmin(dots, dim=-1).to(torch.int32)
    i2 = torch.where(i1 + 1 < count2, i1 + 1, 0).to(torch.int32)
    w1 = m2.xf_vec(p2, q2, _take(verts2, i1))
    w2 = m2.xf_vec(p2, q2, _take(verts2, i2))
    return w1, w2, i1, i2


def _clip_segment(v0, v1, id0, id1, normal, offset, vertex_index_a):
    """b2ClipSegmentToLine on a fixed 2-point segment.

    Returns (out0, out1, ido0, ido1, two_points).  ``two_points`` is False
    whenever fewer than 2 points survive, which kills the manifold.  ``t``
    may be inf or NaN on the branch the selects throw away.
    """
    d0 = m2.dot(normal, v0) - offset
    d1 = m2.dot(normal, v1) - offset
    keep0 = d0 <= 0.0
    keep1 = d1 <= 0.0

    t = d0 / (d0 - d1)
    vi = v0 + t[..., None] * (v1 - v0)
    id_i = make_id(vertex_index_a, (id0 >> 8) & 0xFF, _VERTEX, _FACE)

    out0 = torch.where(keep0[..., None], v0, v1)
    ido0 = torch.where(keep0, id0, id1)
    both = keep0 & keep1
    out1 = torch.where(both[..., None], v1, vi)
    ido1 = torch.where(both, id1, id_i)

    two_points = both | (d0 * d1 < 0.0)
    return out0, out1, ido0, ido1, two_points


def collide_polygons(verts_a, normals_a, count_a, pos_a, q_a,
                     verts_b, normals_b, count_b, pos_b, q_b) -> Manifold:
    """b2CollidePolygons, batched over the leading axes.  Positions are body
    *origins* (fixture frames), rotations are (cos, sin)."""
    count_a = torch.as_tensor(count_a, device=pos_a.device)
    count_b = torch.as_tensor(count_b, device=pos_a.device)
    sep_a, edge_a = _max_separation(
        verts_a, normals_a, count_a, pos_a, q_a, verts_b, count_b, pos_b, q_b
    )
    sep_b, edge_b = _max_separation(
        verts_b, normals_b, count_b, pos_b, q_b, verts_a, count_a, pos_a, q_a
    )
    separated = (sep_a > TOTAL_RADIUS) | (sep_b > TOTAL_RADIUS)

    flip = sep_b > sep_a + CLIP_TOL
    fv = flip[..., None]  # for [..., 2] leaves
    fm = flip[..., None, None]  # for [..., V, 2] leaves

    verts1 = torch.where(fm, verts_b, verts_a)
    normals1 = torch.where(fm, normals_b, normals_a)
    count1 = torch.where(flip, count_b, count_a)
    p1 = torch.where(fv, pos_b, pos_a)
    q1 = torch.where(fv, q_b, q_a)
    verts2 = torch.where(fm, verts_a, verts_b)
    count2 = torch.where(flip, count_a, count_b)
    p2 = torch.where(fv, pos_a, pos_b)
    q2 = torch.where(fv, q_a, q_b)
    normals2 = torch.where(fm, normals_a, normals_b)
    edge1 = torch.where(flip, edge_b, edge_a)

    iw1, iw2, i1, i2 = _incident_edge(normals1, edge1, q1, verts2, normals2, count2, p2, q2)
    inc_id1 = make_id(edge1, i1, _FACE, _VERTEX)
    inc_id2 = make_id(edge1, i2, _FACE, _VERTEX)

    iv1 = edge1
    iv2 = torch.where(edge1 + 1 < count1, edge1 + 1, 0).to(torch.int32)
    v11 = _take(verts1, iv1)
    v12 = _take(verts1, iv2)
    local_tangent = v12 - v11
    norm = torch.sqrt(local_tangent[..., 0] * local_tangent[..., 0]
                      + local_tangent[..., 1] * local_tangent[..., 1])
    local_tangent = local_tangent / norm[..., None]
    local_normal = torch.stack([local_tangent[..., 1], -local_tangent[..., 0]], dim=-1)
    plane_point = 0.5 * (v11 + v12)

    tangent = m2.rot_vec(q1, local_tangent)
    normal = torch.stack([tangent[..., 1], -tangent[..., 0]], dim=-1)
    w11 = m2.xf_vec(p1, q1, v11)
    w12 = m2.xf_vec(p1, q1, v12)

    front_offset = m2.dot(normal, w11)
    side_offset1 = -m2.dot(tangent, w11) + TOTAL_RADIUS
    side_offset2 = m2.dot(tangent, w12) + TOTAL_RADIUS

    c0, c1, cid0, cid1, ok1 = _clip_segment(
        iw1, iw2, inc_id1, inc_id2, -tangent, side_offset1, iv1)
    c0, c1, cid0, cid1, ok2 = _clip_segment(
        c0, c1, cid0, cid1, tangent, side_offset2, iv2)

    # Final separation filter with slot compaction (pointCount++ per pass).
    keep0 = m2.dot(c0, normal) - front_offset <= TOTAL_RADIUS
    keep1 = m2.dot(c1, normal) - front_offset <= TOTAL_RADIUS
    lp0 = m2.xf_vec_t(p2, q2, c0)  # incident-body local frame
    lp1 = m2.xf_vec_t(p2, q2, c1)
    oid0 = torch.where(flip, flip_id(cid0), cid0)
    oid1 = torch.where(flip, flip_id(cid1), cid1)

    count = keep0.to(torch.int32) + keep1.to(torch.int32)
    # compaction: slot 0 takes the first kept point
    pt0 = torch.where(keep0[..., None], lp0, lp1)
    id0 = torch.where(keep0, oid0, oid1)
    points = torch.stack([pt0, lp1], dim=-2)
    ids = torch.stack([id0, oid1], dim=-1)

    dead = separated | ~ok1 | ~ok2
    count = torch.where(dead, 0, count).to(torch.int32)
    slot = torch.arange(2, device=count.device)
    ids = torch.where(slot < count[..., None], ids, -1).to(torch.int32)

    return Manifold(
        flip=flip,
        local_normal=local_normal,
        local_point=plane_point,
        points=points,
        ids=ids,
        count=count,
    )


def match_impulses(new_ids, old_ids, old_normal, old_tangent):
    """b2Contact::Update impulse matching: carry accumulated impulses across
    steps for manifold points whose contact id persists; zero otherwise.
    Slots on the last axis: all arguments ``[*S, 2]``."""
    eq = new_ids[..., :, None] == old_ids[..., None, :]  # [*S, 2_new, 2_old]
    valid = (new_ids[..., :, None] >= 0) & (old_ids[..., None, :] >= 0)
    hit = eq & valid
    first = hit[..., 0]
    second = hit[..., 1] & ~hit[..., 0]
    on = old_normal[..., None, :]
    ot = old_tangent[..., None, :]
    normal = torch.where(first, on[..., 0], torch.where(second, on[..., 1], 0.0))
    tangent = torch.where(first, ot[..., 0], torch.where(second, ot[..., 1], 0.0))
    return normal, tangent
