"""Sequential-impulse contact solver (b2ContactSolver + b2Island semantics).

PyTorch port of ``gym_puzzles_tpu/engine/solver.py``: the same functions,
batched on the trailing env axis instead of vmapped.  Per-pair constants are
computed for all pairs at once (``init_velocity_constraints``); the
Gauss-Seidel sweeps then loop over the *static* pair list in Python, with
every body index a host integer, on per-body ``[E]`` tensors.  Terms that
involve a static body's (zero, never-updated) velocity or position are left
out, which is exact: the JAX code adds ``-0 * x`` there.

Fidelity notes (shared with the JAX package):
* velocity solve order: per contact, friction per point first, then normal
  (2x2 block solver with Box2D's four-case LCP enumeration when the manifold
  has 2 well-conditioned points, else per-point clamped accumulation);
* warm starting with dtRatio=1 (fixed dt);
* Baumgarte position correction (0.2) with slop 0.005, max correction 0.2,
  and the per-island early exit once minSeparation >= -3*slop, with per-island
  done masks so extra iterations are exact no-ops;
* contacts whose dynamic endpoints are asleep are not solved;
* integrate-position clamps (maxTranslation 2.0, maxRotation pi/2) write the
  clamped velocities back, as b2Island does.

This module is the plain version of the fused CUDA tick kernel
(``csrc/step_fused.cu``), which repeats its arithmetic in the same order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference.narrowphase import TOTAL_RADIUS
from portbench.reference.shapes import LINEAR_SLOP, POLYGON_RADIUS
from portbench.reference.types import Replaceable, ShapeTable, device_const

BAUMGARTE = 0.2
MAX_LINEAR_CORRECTION = 0.2
MAX_TRANSLATION = 2.0
MAX_ROTATION = 0.5 * math.pi
VELOCITY_THRESHOLD = 1.0
MAX_CONDITION_NUMBER = 1000.0

# Sleep constants (b2Settings): sleeping is active in box2d-py 2.3.5 (the
# binding's doSleep=False flag is ignored by the vendored C++).
LINEAR_SLEEP_TOL_SQ = 0.01**2
ANGULAR_SLEEP_TOL_SQ = (2.0 / 180.0 * 3.14159265358979) ** 2
TIME_TO_SLEEP = 0.5


@dataclasses.dataclass
class VelocityConstraints(Replaceable):
    """Stacked per-pair constraint data, env axis last."""

    normal: torch.Tensor  # [P, 2, E]
    r_a: torch.Tensor  # [P, 2(points), 2, E]
    r_b: torch.Tensor  # [P, 2, 2, E]
    normal_mass: torch.Tensor  # [P, 2, E] per-point 1/k_ii
    tangent_mass: torch.Tensor  # [P, 2, E]
    bias: torch.Tensor  # [P, 2, E]
    k11: torch.Tensor  # [P, E]
    k12: torch.Tensor
    k22: torch.Tensor
    im11: torch.Tensor  # block inverse
    im12: torch.Tensor
    im22: torch.Tensor
    count: torch.Tensor  # [P, E] effective point count (post conditioning degrade)
    solve: torch.Tensor  # [P, E] bool: pair is in an awake island
    normal_impulse: torch.Tensor  # [P, 2, E] accumulated
    tangent_impulse: torch.Tensor  # [P, 2, E]


def _col(x, device):
    """numpy [N] constant -> tensor [N, 1] broadcasting over the env axis."""
    return device_const(x, device)[:, None]


def _idx(x, device):
    return device_const(np.asarray(x, dtype=np.int64), device)


def dd_links(table: ShapeTable):
    """(body_a, body_b, pair) of every pair whose two bodies are dynamic: the
    only links island labelling and wake propagation follow."""
    dyn = ~table.is_static
    return [(int(table.pair_body_a[p]), int(table.pair_body_b[p]), p)
            for p in range(table.num_pairs)
            if dyn[table.pair_body_a[p]] and dyn[table.pair_body_b[p]]]


def compute_islands(table: ShapeTable, touching):
    """Connected components over *dynamic* bodies linked by touching
    contacts (static walls do not merge islands).

    ``touching`` [P, E] bool.  Returns int64 labels [B, E]: min body index in
    the component; static bodies keep their own index.  ``max(1, n_dyn)``
    in-order rounds of min-propagation over the dynamic-dynamic pairs."""
    B = table.num_bodies
    E = touching.shape[-1]
    labels = [torch.full((E,), b, dtype=torch.int64, device=touching.device)
              for b in range(B)]
    rounds = int((~table.is_static).sum())
    links = dd_links(table)
    for _ in range(max(1, rounds)):
        for ia, ib, p in links:
            lnk = touching[p]
            m = torch.minimum(labels[ia], labels[ib])
            labels[ia] = torch.where(lnk, m, labels[ia])
            labels[ib] = torch.where(lnk, m, labels[ib])
    return torch.stack(labels)


def propagate_wake(table: ShapeTable, labels, awake, sleep_time):
    """Every dynamic body sharing an island with an awake body is woken
    (b2World::Solve); waking resets the sleep timer.  [B, E] in and out."""
    same = labels[:, None, :] == labels[None, :, :]  # [B(body), B(other), E]
    dyn = _col(~table.is_static, labels.device)
    new_awake = (same & awake[None, :, :]).any(dim=1) & dyn
    woke = new_awake & ~awake
    return new_awake, torch.where(woke, 0.0, sleep_time)


def _world_manifold(table, man, origin_x, origin_y, qc, qs):
    """b2WorldManifold::Initialize for every pair.  Returns the A->B normal
    (nx, ny) [P, E] and the world points (wx, wy) [P, 2, E]."""
    dev = qc.device
    ia = _idx(table.pair_body_a, dev)
    ib = _idx(table.pair_body_b, dev)
    flip = man.flip

    def sel(f, a, b):
        return torch.where(f, b, a)

    prx = sel(flip, origin_x[ia], origin_x[ib])
    pry = sel(flip, origin_y[ia], origin_y[ib])
    qrc = sel(flip, qc[ia], qc[ib])
    qrs = sel(flip, qs[ia], qs[ib])
    pix = sel(flip, origin_x[ib], origin_x[ia])
    piy = sel(flip, origin_y[ib], origin_y[ia])
    qic = sel(flip, qc[ib], qc[ia])
    qis = sel(flip, qs[ib], qs[ia])

    lnx, lny = man.local_normal[:, 0], man.local_normal[:, 1]
    lpx, lpy = man.local_point[:, 0], man.local_point[:, 1]
    nx = qrc * lnx - qrs * lny
    ny = qrs * lnx + qrc * lny
    ppx = (qrc * lpx - qrs * lpy) + prx
    ppy = (qrs * lpx + qrc * lpy) + pry

    mpx, mpy = man.points[:, :, 0], man.points[:, :, 1]  # [P, 2, E]
    cx = (qic[:, None] * mpx - qis[:, None] * mpy) + pix[:, None]
    cy = (qis[:, None] * mpx + qic[:, None] * mpy) + piy[:, None]
    nx2, ny2 = nx[:, None], ny[:, None]
    d = (cx - ppx[:, None]) * nx2 + (cy - ppy[:, None]) * ny2
    crx = cx + (POLYGON_RADIUS - d) * nx2
    cry = cy + (POLYGON_RADIUS - d) * ny2
    cix = cx - POLYGON_RADIUS * nx2
    ciy = cy - POLYGON_RADIUS * ny2
    wx = 0.5 * (crx + cix)
    wy = 0.5 * (cry + ciy)
    return torch.where(flip, -nx, nx), torch.where(flip, -ny, ny), wx, wy


def init_velocity_constraints(table: ShapeTable, man, pos, angle, vel, omega,
                              matched_n, matched_t, active) -> VelocityConstraints:
    """b2ContactSolver::InitializeVelocityConstraints over all pairs.

    ``pos`` is the world COM [B, 2, E]; manifold transforms need body
    origins.  ``active`` [B, E] marks awake dynamic bodies; pairs without an
    active endpoint are excluded from the solve."""
    dev = pos.device
    ia = _idx(table.pair_body_a, dev)
    ib = _idx(table.pair_body_b, dev)
    qc, qs = torch.cos(angle), torch.sin(angle)
    lcx = _col(table.local_center[:, 0], dev)
    lcy = _col(table.local_center[:, 1], dev)
    origin_x = pos[:, 0] - (qc * lcx - qs * lcy)
    origin_y = pos[:, 1] - (qs * lcx + qc * lcy)

    nx, ny, wx, wy = _world_manifold(table, man, origin_x, origin_y, qc, qs)

    rax = wx - pos[ia, 0][:, None]
    ray = wy - pos[ia, 1][:, None]
    rbx = wx - pos[ib, 0][:, None]
    rby = wy - pos[ib, 1][:, None]

    m_sum = device_const(table.inv_mass[table.pair_body_a]
                         + table.inv_mass[table.pair_body_b], dev)[:, None, None]
    i_a = device_const(table.inv_inertia[table.pair_body_a], dev)[:, None, None]
    i_b = device_const(table.inv_inertia[table.pair_body_b], dev)[:, None, None]

    nx2, ny2 = nx[:, None], ny[:, None]
    rn_a = rax * ny2 - ray * nx2  # [P, 2, E]
    rn_b = rbx * ny2 - rby * nx2
    k_normal = m_sum + i_a * (rn_a * rn_a) + i_b * (rn_b * rn_b)
    normal_mass = torch.where(k_normal > 0.0, 1.0 / k_normal, 0.0)

    tx2, ty2 = ny2, -nx2  # tangent = cross(n, 1)
    rt_a = rax * ty2 - ray * tx2
    rt_b = rbx * ty2 - rby * tx2
    k_tangent = m_sum + i_a * (rt_a * rt_a) + i_b * (rt_b * rt_b)
    tangent_mass = torch.where(k_tangent > 0.0, 1.0 / k_tangent, 0.0)

    # Relative normal velocity for the restitution bias.
    vax, vay, oma = vel[ia, 0][:, None], vel[ia, 1][:, None], omega[ia][:, None]
    vbx, vby, omb = vel[ib, 0][:, None], vel[ib, 1][:, None], omega[ib][:, None]
    dvx = vbx - omb * rby - vax + oma * ray
    dvy = vby + omb * rbx - vay - oma * rax
    v_rel = dvx * nx2 + dvy * ny2
    neg_rest = device_const(-table.pair_restitution, dev)[:, None, None]
    bias = torch.where(v_rel < -VELOCITY_THRESHOLD, neg_rest * v_rel, 0.0)

    # 2-point block matrix + conditioning degrade.
    k11 = k_normal[:, 0]
    k22 = k_normal[:, 1]
    k12 = m_sum[:, 0] + i_a[:, 0] * rn_a[:, 0] * rn_a[:, 1] + i_b[:, 0] * rn_b[:, 0] * rn_b[:, 1]
    det = k11 * k22 - k12 * k12
    cond_ok = k11 * k11 < MAX_CONDITION_NUMBER * det
    count = torch.where((man.count == 2) & ~cond_ok, 1, man.count).to(torch.int32)

    inv_det = torch.where(det != 0.0, 1.0 / det, 0.0)
    solve = (man.count > 0) & (active[ia] | active[ib])

    return VelocityConstraints(
        normal=torch.stack([nx, ny], dim=1),
        r_a=torch.stack([rax, ray], dim=2),
        r_b=torch.stack([rbx, rby], dim=2),
        normal_mass=normal_mass,
        tangent_mass=tangent_mass,
        bias=bias,
        k11=k11,
        k12=k12,
        k22=k22,
        im11=inv_det * k22,
        im12=-inv_det * k12,
        im22=inv_det * k11,
        count=count,
        solve=solve,
        normal_impulse=matched_n,
        tangent_impulse=matched_t,
    )


class _Bodies:
    """Per-body ``[E]`` component lists for the Gauss-Seidel loops, with the
    static table's constants as host floats."""

    def __init__(self, table: ShapeTable, x, y, w):
        self.dyn = [not bool(s) for s in table.is_static]
        self.inv_m = [float(v) for v in table.inv_mass]
        self.inv_i = [float(v) for v in table.inv_inertia]
        self.x = list(x.unbind(0))
        self.y = list(y.unbind(0))
        self.w = list(w.unbind(0))

    def apply(self, a, b, rax, ray, rbx, rby, px, py):
        """Impulse (px, py) at lever arms r_a / r_b: -P on body a, +P on b."""
        if self.dyn[a]:
            self.x[a] = self.x[a] - self.inv_m[a] * px
            self.y[a] = self.y[a] - self.inv_m[a] * py
            self.w[a] = self.w[a] - self.inv_i[a] * (rax * py - ray * px)
        if self.dyn[b]:
            self.x[b] = self.x[b] + self.inv_m[b] * px
            self.y[b] = self.y[b] + self.inv_m[b] * py
            self.w[b] = self.w[b] + self.inv_i[b] * (rbx * py - rby * px)

    def rel_vel(self, a, b, rax, ray, rbx, rby):
        """v_b + w_b x r_b - v_a - w_a x r_a, dropping static (zero) terms."""
        if self.dyn[a] and self.dyn[b]:
            dvx = self.x[b] - self.w[b] * rby - self.x[a] + self.w[a] * ray
            dvy = self.y[b] + self.w[b] * rbx - self.y[a] - self.w[a] * rax
        elif self.dyn[b]:
            dvx = self.x[b] - self.w[b] * rby
            dvy = self.y[b] + self.w[b] * rbx
        else:
            dvx = self.w[a] * ray - self.x[a]
            dvy = -self.y[a] - self.w[a] * rax
        return dvx, dvy

    def stack(self):
        return torch.stack(self.x), torch.stack(self.y), torch.stack(self.w)


def _pair_rows(vc: VelocityConstraints, p: int):
    """One pair's constraint rows as [E] tensors."""
    return dict(
        nx=vc.normal[p, 0], ny=vc.normal[p, 1],
        rax=vc.r_a[p, :, 0], ray=vc.r_a[p, :, 1],
        rbx=vc.r_b[p, :, 0], rby=vc.r_b[p, :, 1],
        nm=vc.normal_mass[p], tm=vc.tangent_mass[p], bias=vc.bias[p],
        k11=vc.k11[p], k12=vc.k12[p], k22=vc.k22[p],
        im11=vc.im11[p], im12=vc.im12[p], im22=vc.im22[p],
        cnt=torch.where(vc.solve[p], vc.count[p], 0),
    )


def warm_start(table: ShapeTable, vc: VelocityConstraints, vel, omega):
    """Apply accumulated impulses (b2ContactSolver::WarmStart), masked to the
    effective point count and to solved pairs.  Returns (vel, omega)."""
    bd = _Bodies(table, vel[:, 0], vel[:, 1], omega)
    for p in range(table.num_pairs):
        ia, ib = int(table.pair_body_a[p]), int(table.pair_body_b[p])
        c = _pair_rows(vc, p)
        nx, ny = c["nx"], c["ny"]
        tx, ty = ny, -nx
        for j in range(2):
            mask = j < c["cnt"]
            imp = torch.where(mask, vc.normal_impulse[p, j], 0.0)
            timp = torch.where(mask, vc.tangent_impulse[p, j], 0.0)
            bd.apply(ia, ib, c["rax"][j], c["ray"][j], c["rbx"][j], c["rby"][j],
                     imp * nx + timp * tx, imp * ny + timp * ty)
    x, y, w = bd.stack()
    return torch.stack([x, y], dim=1), w


def solve_velocity_constraints(table: ShapeTable, vc: VelocityConstraints, vel, omega,
                               iters: int):
    """b2ContactSolver::SolveVelocityConstraints x iters, Gauss-Seidel over
    the static pair list.  Returns (vel, omega, vc with final impulses)."""
    P = table.num_pairs
    bd = _Bodies(table, vel[:, 0], vel[:, 1], omega)
    rows = [_pair_rows(vc, p) for p in range(P)]
    body = [(int(table.pair_body_a[p]), int(table.pair_body_b[p])) for p in range(P)]
    fric = [float(f) for f in table.pair_friction]
    n_imp = [list(vc.normal_impulse[p].unbind(0)) for p in range(P)]
    t_imp = [list(vc.tangent_impulse[p].unbind(0)) for p in range(P)]

    for _ in range(iters):
        for p in range(P):
            ia, ib = body[p]
            c = rows[p]
            nx, ny = c["nx"], c["ny"]
            tx, ty = ny, -nx
            cnt = c["cnt"]
            ni, ti = n_imp[p], t_imp[p]
            rax, ray, rbx, rby = c["rax"], c["ray"], c["rbx"], c["rby"]

            # friction, per point, bounded by the current normal impulse
            for j in range(2):
                dvx, dvy = bd.rel_vel(ia, ib, rax[j], ray[j], rbx[j], rby[j])
                vt = dvx * tx + dvy * ty
                lam = c["tm"][j] * (-vt)
                max_f = fric[p] * ni[j]
                new_imp = torch.minimum(torch.maximum(ti[j] + lam, -max_f), max_f)
                lam = torch.where(j < cnt, new_imp - ti[j], 0.0)
                ti[j] = ti[j] + lam
                bd.apply(ia, ib, rax[j], ray[j], rbx[j], rby[j], lam * tx, lam * ty)

            # normal: single point
            dv0x, dv0y = bd.rel_vel(ia, ib, rax[0], ray[0], rbx[0], rby[0])
            vn0 = dv0x * nx + dv0y * ny
            lam0 = -c["nm"][0] * (vn0 - c["bias"][0])
            d_single = torch.clamp_min(ni[0] + lam0, 0.0) - ni[0]

            # normal: 2x2 block solver (Box2D case enumeration, in order)
            a1, a2 = ni[0], ni[1]
            dv2x, dv2y = bd.rel_vel(ia, ib, rax[1], ray[1], rbx[1], rby[1])
            vn2 = dv2x * nx + dv2y * ny
            k11, k12, k22 = c["k11"], c["k12"], c["k22"]
            b1 = vn0 - c["bias"][0] - (k11 * a1 + k12 * a2)
            b2 = vn2 - c["bias"][1] - (k12 * a1 + k22 * a2)

            x1_1 = -(c["im11"] * b1 + c["im12"] * b2)
            x2_1 = -(c["im12"] * b1 + c["im22"] * b2)
            ok1 = (x1_1 >= 0.0) & (x2_1 >= 0.0)
            x1_2 = -c["nm"][0] * b1
            ok2 = (x1_2 >= 0.0) & (k12 * x1_2 + b2 >= 0.0)
            x2_3 = -c["nm"][1] * b2
            ok3 = (x2_3 >= 0.0) & (k12 * x2_3 + b1 >= 0.0)
            ok4 = (b1 >= 0.0) & (b2 >= 0.0)

            x1 = torch.where(ok1, x1_1, torch.where(ok2, x1_2, 0.0))
            x2 = torch.where(ok1, x2_1, torch.where(ok3, x2_3, 0.0))
            applied = ok1 | ok2 | ok3 | ok4
            d1_blk = torch.where(applied, x1 - a1, 0.0)
            d2_blk = torch.where(applied, x2 - a2, 0.0)

            d1 = torch.where(cnt == 2, d1_blk, torch.where(cnt == 1, d_single, 0.0))
            d2 = torch.where(cnt == 2, d2_blk, 0.0)
            ni[0] = ni[0] + d1
            ni[1] = ni[1] + d2

            # both points' impulses applied as one (p1 + p2), as world.step does
            p1x, p1y, p2x, p2y = d1 * nx, d1 * ny, d2 * nx, d2 * ny
            sx, sy = p1x + p2x, p1y + p2y
            if bd.dyn[ia]:
                bd.x[ia] = bd.x[ia] - bd.inv_m[ia] * sx
                bd.y[ia] = bd.y[ia] - bd.inv_m[ia] * sy
                bd.w[ia] = bd.w[ia] - bd.inv_i[ia] * (
                    (rax[0] * p1y - ray[0] * p1x) + (rax[1] * p2y - ray[1] * p2x))
            if bd.dyn[ib]:
                bd.x[ib] = bd.x[ib] + bd.inv_m[ib] * sx
                bd.y[ib] = bd.y[ib] + bd.inv_m[ib] * sy
                bd.w[ib] = bd.w[ib] + bd.inv_i[ib] * (
                    (rbx[0] * p1y - rby[0] * p1x) + (rbx[1] * p2y - rby[1] * p2x))

    x, y, w = bd.stack()
    vc = vc.replace(
        normal_impulse=torch.stack([torch.stack(n) for n in n_imp]) if P else vc.normal_impulse,
        tangent_impulse=torch.stack([torch.stack(t) for t in t_imp]) if P else vc.tangent_impulse,
    )
    return torch.stack([x, y], dim=1), w, vc


def integrate_positions(pos, angle, vel, omega, dt, active):
    """b2Island position integration with translation/rotation clamps; the
    clamped velocities are written back.  Sleeping bodies don't move."""
    tx = dt * vel[:, 0]
    ty = dt * vel[:, 1]
    t2 = tx * tx + ty * ty
    scale = torch.where(
        t2 > MAX_TRANSLATION**2,
        MAX_TRANSLATION / torch.sqrt(torch.clamp_min(t2, 1e-30)), 1.0,
    )
    vel = vel * scale[:, None]
    rotation = dt * omega
    rscale = torch.where(
        rotation * rotation > MAX_ROTATION**2, MAX_ROTATION / torch.abs(rotation), 1.0
    )
    omega = omega * rscale
    return (
        torch.where(active[:, None], pos + dt * vel, pos),
        torch.where(active, angle + dt * omega, angle),
        vel,
        omega,
    )


def solve_position_constraints(table: ShapeTable, man, pos, angle, iters: int, solve_mask,
                               labels):
    """b2ContactSolver::SolvePositionConstraints x iters with b2Island's
    early exit (minSeparation >= -3*slop), per island: ``done`` and the
    running minimum separation are [B, E] tensors keyed by island label.

    Returns (pos, angle, island_position_solved [B, E] keyed by label)."""
    P, B = table.num_pairs, table.num_bodies
    E = angle.shape[-1]
    dev = angle.device
    done = torch.zeros((B, E), dtype=torch.bool, device=dev)
    if P == 0:
        return pos, angle, torch.ones((B, E), dtype=torch.bool, device=dev)

    dyn = [not bool(s) for s in table.is_static]
    inv_m = [float(v) for v in table.inv_mass]
    inv_i = [float(v) for v in table.inv_inertia]
    lcx = [float(v) for v in table.local_center[:, 0]]
    lcy = [float(v) for v in table.local_center[:, 1]]
    # island of a pair: label of its first dynamic endpoint
    rep = [int(table.pair_body_a[p]) if dyn[table.pair_body_a[p]] else int(table.pair_body_b[p])
           for p in range(P)]
    pair_island = [labels[rep[p]][None] for p in range(P)]

    px, py = list(pos[:, 0].unbind(0)), list(pos[:, 1].unbind(0))
    an = list(angle.unbind(0))
    flip = [man.flip[p] for p in range(P)]
    cnt = [man.count[p] for p in range(P)]

    def transform(b):
        """(cos, sin, origin x, origin y) of body b at its current pose."""
        c, s = torch.cos(an[b]), torch.sin(an[b])
        return c, s, px[b] - (c * lcx[b] - s * lcy[b]), py[b] - (s * lcx[b] + c * lcy[b])

    for _ in range(iters):
        min_sep = torch.zeros((B, E), dtype=angle.dtype, device=dev)
        for p in range(P):
            ia, ib = int(table.pair_body_a[p]), int(table.pair_body_b[p])
            solve = solve_mask[p]
            pair_done = torch.gather(done, 0, pair_island[p])[0] | ~solve
            # transforms once per contact (b2 semantics): point 1 reuses the
            # pre-point-0 transform; only the COM lever arms see the update
            ca, sa, oax, oay = transform(ia)
            cb, sb, obx, oby = transform(ib)
            f = flip[p]
            cr, sr = torch.where(f, cb, ca), torch.where(f, sb, sa)
            orx, ory = torch.where(f, obx, oax), torch.where(f, oby, oay)
            ci, si = torch.where(f, ca, cb), torch.where(f, sa, sb)
            oix, oiy = torch.where(f, oax, obx), torch.where(f, oay, oby)
            lnx, lny = man.local_normal[p, 0], man.local_normal[p, 1]
            lpx, lpy = man.local_point[p, 0], man.local_point[p, 1]
            nwx = cr * lnx - sr * lny
            nwy = sr * lnx + cr * lny
            ppx = (cr * lpx - sr * lpy) + orx
            ppy = (sr * lpx + cr * lpy) + ory
            nx, ny = torch.where(f, -nwx, nwx), torch.where(f, -nwy, nwy)
            for j in range(2):
                has = j < cnt[p]
                active = has & ~pair_done
                track = has & solve
                mpx, mpy = man.points[p, j, 0], man.points[p, j, 1]
                cpx = (ci * mpx - si * mpy) + oix
                cpy = (si * mpx + ci * mpy) + oiy
                sep = (cpx - ppx) * nwx + (cpy - ppy) * nwy - TOTAL_RADIUS
                min_sep.scatter_reduce_(0, pair_island[p], torch.where(track, sep, 0.0)[None],
                                        reduce="amin")
                c = torch.clamp(BAUMGARTE * (sep + LINEAR_SLOP), -MAX_LINEAR_CORRECTION, 0.0)
                rax, ray = cpx - px[ia], cpy - py[ia]
                rbx, rby = cpx - px[ib], cpy - py[ib]
                k = inv_m[ia] + inv_m[ib]
                if dyn[ia]:
                    rn_a = rax * ny - ray * nx
                    k = k + inv_i[ia] * (rn_a * rn_a)
                if dyn[ib]:
                    rn_b = rbx * ny - rby * nx
                    k = k + inv_i[ib] * (rn_b * rn_b)
                impulse = torch.where((k > 0.0) & active, -c / k, 0.0)
                pix, piy = impulse * nx, impulse * ny
                if dyn[ia]:
                    px[ia] = px[ia] - inv_m[ia] * pix
                    py[ia] = py[ia] - inv_m[ia] * piy
                    an[ia] = an[ia] - inv_i[ia] * (rax * piy - ray * pix)
                if dyn[ib]:
                    px[ib] = px[ib] + inv_m[ib] * pix
                    py[ib] = py[ib] + inv_m[ib] * piy
                    an[ib] = an[ib] + inv_i[ib] * (rbx * piy - rby * pix)
        done = done | (min_sep >= -3.0 * LINEAR_SLOP)

    return torch.stack([torch.stack(px), torch.stack(py)], dim=1), torch.stack(an), done


def update_sleep(table: ShapeTable, labels, awake, sleep_time, vel, omega, dt,
                 position_solved):
    """End-of-step sleep bookkeeping (b2Island::Solve tail).

    Awake dynamic bodies moving below the sleep tolerances accumulate sleep
    time; when every body in an island has slept >= TIME_TO_SLEEP and the
    island's position solve converged, the whole island is put to sleep with
    velocities zeroed."""
    dyn = _col(~table.is_static, awake.device)
    active = awake & dyn

    fast = ((vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1] > LINEAR_SLEEP_TOL_SQ)
            | (omega * omega > ANGULAR_SLEEP_TOL_SQ))
    sleep_time = torch.where(active, torch.where(fast, 0.0, sleep_time + dt), sleep_time)

    same = labels[:, None, :] == labels[None, :, :]  # [B(body), B(other), E]
    vals = torch.where(active, sleep_time, torch.inf)
    body_island_min = torch.where(same, vals[None, :, :], torch.inf).amin(dim=1)
    body_pos_solved = torch.gather(position_solved, 0, labels)
    goes_to_sleep = (body_island_min >= TIME_TO_SLEEP) & body_pos_solved & active

    awake = awake & ~goes_to_sleep
    vel = torch.where(goes_to_sleep[:, None], 0.0, vel)
    omega = torch.where(goes_to_sleep, 0.0, omega)
    sleep_time = torch.where(goes_to_sleep, 0.0, sleep_time)
    return awake, sleep_time, vel, omega
