"""Build-time polygon geometry: convex hulls, edge normals, mass properties.

The port's own copy of ``gym_puzzles_tpu/engine/shapes.py`` (numpy only, so
the port never imports the JAX package).  Everything here runs once, on the
host, in numpy float64 --> float32, when an environment variant's static
:class:`ShapeTable` is assembled.

The hull ordering and the mass/inertia integration reproduce Box2D's
``b2PolygonShape::Set`` / ``ComputeMass`` semantics (the reference's
multi_robot_puzzle_00.py:322-351 builds block fixtures from boxes, :368-376
builds octagon agents from a free vertex list; box2d reorders free vertex
lists by its hull code, which matters for contact feature ids and
incident-edge tie-breaks).  Held equal to the JAX package's tables in
tests/test_torch_tables.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Box2D tuning constants (b2Settings.h equivalents) -- shared with the solver.
LINEAR_SLOP = 0.005
POLYGON_RADIUS = 2.0 * LINEAR_SLOP
MAX_POLYGON_VERTICES = 8


def cross2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """2D scalar cross product a.x*b.y - a.y*b.x."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Gift-wrap convex hull with Box2D's starting point and tie-breaking.

    Starts from the rightmost-lowest vertex and walks counter-clockwise,
    preferring the farther point on collinear ties.  Returns the hull vertices
    in Box2D's order, which is what ``polygonShape(vertices=...)`` stores.
    """
    ps = np.asarray(points, dtype=np.float64)
    n = len(ps)
    if n < 3:
        raise ValueError("polygon needs >= 3 vertices")

    # Rightmost vertex; lowest y on ties.
    i0 = 0
    x0 = ps[0, 0]
    for i in range(1, n):
        x = ps[i, 0]
        if x > x0 or (x == x0 and ps[i, 1] < ps[i0, 1]):
            i0 = i
            x0 = x

    hull = []
    ih = i0
    while True:
        hull.append(ih)
        ie = 0
        for j in range(1, n):
            if ie == ih:
                ie = j
                continue
            r = ps[ie] - ps[hull[-1]]
            v = ps[j] - ps[hull[-1]]
            c = cross2(r, v)
            if c < 0.0:
                ie = j
            if c == 0.0 and v @ v > r @ r:
                ie = j
        ih = ie
        if ie == i0:
            break
    return ps[hull]


def box_vertices(hx: float, hy: float, center=(0.0, 0.0), angle: float = 0.0) -> np.ndarray:
    """Vertices of a box fixture in Box2D's ``SetAsBox`` order.

    Order: (-hx,-hy), (hx,-hy), (hx,hy), (-hx,hy), offset by center (the
    reference's block fixtures never rotate the box, but support it anyway).
    This fixed order is observable in the reference's saved vertex lists
    (multi_robot_puzzle_00.py:356-361) and hence in the vertex observations.
    """
    v = np.array([[-hx, -hy], [hx, -hy], [hx, hy], [-hx, hy]], dtype=np.float64)
    if angle != 0.0:
        c, s = np.cos(angle), np.sin(angle)
        v = v @ np.array([[c, s], [-s, c]])
    return v + np.asarray(center, dtype=np.float64)


def edge_normals(vertices: np.ndarray) -> np.ndarray:
    """Outward edge normals of a CCW polygon: normalize(cross(edge, 1))."""
    v = np.asarray(vertices, dtype=np.float64)
    edges = np.roll(v, -1, axis=0) - v
    normals = np.stack([edges[:, 1], -edges[:, 0]], axis=-1)
    lengths = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / lengths


@dataclasses.dataclass
class MassData:
    mass: float
    center: np.ndarray  # centroid in body-local coordinates
    inertia_origin: float  # rotational inertia about the body origin


def polygon_mass(vertices: np.ndarray, density: float) -> MassData:
    """Polygon mass properties via triangle-fan integration about the vertex
    mean, matching Box2D's ``ComputeMass`` (inertia returned about the body
    origin, as fixtures report it)."""
    v = np.asarray(vertices, dtype=np.float64)
    n = len(v)
    s = v.mean(axis=0)
    k_inv3 = 1.0 / 3.0

    area = 0.0
    center = np.zeros(2)
    inertia = 0.0
    for i in range(n):
        e1 = v[i] - s
        e2 = v[(i + 1) % n] - s
        d = cross2(e1, e2)
        tri_area = 0.5 * d
        area += tri_area
        center += tri_area * k_inv3 * (e1 + e2)
        intx2 = e1[0] * e1[0] + e2[0] * e1[0] + e2[0] * e2[0]
        inty2 = e1[1] * e1[1] + e2[1] * e1[1] + e2[1] * e2[1]
        inertia += (0.25 * k_inv3 * d) * (intx2 + inty2)

    center *= 1.0 / area
    mass = density * area
    abs_center = center + s
    inertia_origin = density * inertia + mass * (abs_center @ abs_center - center @ center)
    return MassData(mass=mass, center=abs_center, inertia_origin=inertia_origin)


def body_mass(fixture_vertices: list[np.ndarray], densities: list[float]):
    """Combine fixture mass data into body mass, local COM and inertia,
    including Box2D's zero-mass fallback (mass=1, I=0) for bodies whose
    fixtures all have zero density -- the v0 agents rely on this
    (multi_robot_puzzle_00.py:368-376: no density given -> fallback).

    Returns (mass, local_center, inertia_about_com).
    """
    mass = 0.0
    center = np.zeros(2)
    inertia = 0.0
    for verts, density in zip(fixture_vertices, densities):
        if density == 0.0:
            continue
        md = polygon_mass(verts, density)
        mass += md.mass
        center += md.mass * md.center
        inertia += md.inertia_origin

    if mass > 0.0:
        center *= 1.0 / mass
        inertia -= mass * (center @ center)
    else:
        mass = 1.0
        center = np.zeros(2)
        inertia = 0.0
    return mass, center, inertia
