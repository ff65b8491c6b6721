"""2D rigid transform math on tensors, broadcasting over leading axes.

Rotations are (cos, sin) pairs stacked on the last axis; transforms are
(origin, rot) tuples.  Mirrors Box2D's b2Rot / b2Transform algebra, and the
JAX package's ``engine/math2d.py`` operation for operation, so both round the
same way.
"""

from __future__ import annotations

import torch


def rot(angle):
    """Rotation [..., 2] = (cos, sin)."""
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def rot_vec(q, v):
    """Apply rotation: b2Mul(q, v)."""
    c, s = q[..., 0], q[..., 1]
    return torch.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], dim=-1)


def rot_vec_t(q, v):
    """Apply inverse rotation: b2MulT(q, v)."""
    c, s = q[..., 0], q[..., 1]
    return torch.stack([c * v[..., 0] + s * v[..., 1], -s * v[..., 0] + c * v[..., 1]], dim=-1)


def rot_mul_t(q2, q1):
    """Compose b2MulT(q2, q1): rotation by (angle1 - angle2)."""
    c = q1[..., 0] * q2[..., 0] + q1[..., 1] * q2[..., 1]
    s = q1[..., 1] * q2[..., 0] - q1[..., 0] * q2[..., 1]
    return torch.stack([c, s], dim=-1)


def xf_vec(p, q, v):
    """b2Mul(xf, v) = q*v + p."""
    return rot_vec(q, v) + p


def xf_vec_t(p, q, v):
    """b2MulT(xf, v) = qT*(v - p)."""
    return rot_vec_t(q, v - p)


def cross_vv(a, b):
    """Scalar cross of two vectors."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def body_origin(pos, q, local_center):
    """Body origin from world COM: xf.p = c - q*localCenter (b2Sweep)."""
    return pos - rot_vec(q, local_center)
