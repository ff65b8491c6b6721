"""Engine step: the batched replacement for ``b2World::Step``, plain PyTorch.

A frozen copy of the port's plain tick (``gym_puzzles_tpu_torch/engine/
world.py::step`` with ``solver_cuda.solve_contacts_plain``), kept with the
benchmark so that a change to the port cannot move its yardstick.  One call is one physics
tick for a batch of envs, env axis last on every tensor:

    narrow phase for pairs with an awake dynamic endpoint
      -> touch events + warm-start impulse matching   [b2ContactManager::Collide]
    island labeling + wake propagation                 [b2World::Solve traversal]
    integrate velocities + damping (awake bodies)      [b2Island::Solve]
    init velocity constraints, warm start
    velocity iterations (sequential impulses)
    integrate positions (clamped)
    position iterations (Baumgarte, per-island early exit)
    sleep bookkeeping (velocity zeroing!)              [b2Island::Solve tail]

At the reference's 180/60 iterations :func:`step` issues a few hundred
thousand small tensor operations per tick, so it is slow in eager mode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import narrowphase as nph
from portbench.reference import solver as slv
from portbench.reference.types import Bodies, Contacts, Replaceable, ShapeTable
from portbench.reference.types import device_const as _const


@dataclasses.dataclass
class StepInfo(Replaceable):
    """Per-pair contact outcome of one tick, for env-layer flags ([P, E])."""

    touching: torch.Tensor  # manifold non-empty at tick start
    begin: torch.Tensor  # touch began this tick
    end: torch.Tensor  # touch ended this tick


def init_bodies(table: ShapeTable, origin_pos, angle) -> Bodies:
    """Build body state from body-*origin* positions [B, 2, E] (what
    CreateDynamicBody takes) and angles [B, E]; stores the world COM like
    Box2D's sweep.  Bodies start awake with zero velocity."""
    origin_pos = torch.as_tensor(origin_pos, dtype=torch.float32)
    angle = torch.as_tensor(angle, dtype=torch.float32, device=origin_pos.device)
    dev = origin_pos.device
    c, s = torch.cos(angle), torch.sin(angle)
    lcx = _const(table.local_center[:, 0], dev)[:, None]
    lcy = _const(table.local_center[:, 1], dev)[:, None]
    com = torch.stack([origin_pos[:, 0] + (c * lcx - s * lcy),
                       origin_pos[:, 1] + (s * lcx + c * lcy)], dim=1)
    return Bodies(
        pos=com,
        angle=angle,
        vel=torch.zeros_like(origin_pos),
        omega=torch.zeros_like(angle),
        awake=torch.ones(angle.shape, dtype=torch.bool, device=dev),
        sleep_time=torch.zeros_like(angle),
    )


def init_contacts(table: ShapeTable, num_envs: int, device=None) -> Contacts:
    P, E = table.num_pairs, num_envs
    f = dict(dtype=torch.float32, device=device)
    return Contacts(
        man=nph.Manifold(
            flip=torch.zeros((P, E), dtype=torch.bool, device=device),
            local_normal=torch.zeros((P, 2, E), **f),
            local_point=torch.zeros((P, 2, E), **f),
            points=torch.zeros((P, 2, 2, E), **f),
            ids=torch.full((P, 2, E), -1, dtype=torch.int32, device=device),
            count=torch.zeros((P, E), dtype=torch.int32, device=device),
        ),
        normal_impulse=torch.zeros((P, 2, E), **f),
        tangent_impulse=torch.zeros((P, 2, E), **f),
        touching=torch.zeros((P, E), dtype=torch.bool, device=device),
    )


def body_origins(table: ShapeTable, bodies: Bodies):
    """World origin positions [B, 2, E] (b2Body::GetPosition) and rotations
    (cos, sin) [B, 2, E]."""
    dev = bodies.angle.device
    c, s = torch.cos(bodies.angle), torch.sin(bodies.angle)
    lcx = _const(table.local_center[:, 0], dev)[:, None]
    lcy = _const(table.local_center[:, 1], dev)[:, None]
    origin = torch.stack([bodies.pos[:, 0] - (c * lcx - s * lcy),
                          bodies.pos[:, 1] - (s * lcx + c * lcy)], dim=1)
    return origin, torch.stack([c, s], dim=1)


def collide_all(table: ShapeTable, bodies: Bodies) -> nph.Manifold:
    """Narrow phase over the dense static pair list, all pairs at once.
    Returns the manifold in state layout (env axis last)."""
    dev = bodies.angle.device
    origin, q = body_origins(table, bodies)
    origin = origin.movedim(1, -1)  # [B, E, 2]
    q = q.movedim(1, -1)
    ia = _const(table.pair_body_a.astype(np.int64), dev)
    ib = _const(table.pair_body_b.astype(np.int64), dev)
    fa, fb = table.pair_fix_a, table.pair_fix_b

    def fix(arr, idx):
        return _const(arr[idx], dev)[:, None]  # [P, 1, ...] broadcast over E

    man = nph.collide_polygons(
        fix(table.fix_verts, fa), fix(table.fix_normals, fa), fix(table.fix_count, fa),
        origin[ia], q[ia],
        fix(table.fix_verts, fb), fix(table.fix_normals, fb), fix(table.fix_count, fb),
        origin[ib], q[ib],
    )
    # Sanitize dead/padded slots so downstream masked math never sees NaN.
    slot_alive = torch.arange(2, device=dev) < man.count[..., None]  # [P, E, 2]
    points = torch.where(slot_alive[..., None], man.points, 0.0)
    return nph.Manifold(
        flip=man.flip,
        local_normal=man.local_normal.movedim(-1, 1),  # [P, 2, E]
        local_point=man.local_point.movedim(-1, 1),
        points=points.permute(0, 2, 3, 1),  # [P, 2, 2, E]
        ids=man.ids.movedim(-1, 1),
        count=man.count,
    )


def _select(mask, new, old):
    """Per-pair select between two manifolds; ``mask`` [P, E]."""
    def sel(x, y):
        m = mask.reshape(mask.shape[:1] + (1,) * (x.ndim - 2) + mask.shape[1:])
        return torch.where(m, x, y)

    return nph.Manifold(**{f.name: sel(getattr(new, f.name), getattr(old, f.name))
                           for f in dataclasses.fields(nph.Manifold)})


def before_solve(table: ShapeTable, bodies: Bodies, contacts: Contacts, force, torque, wake,
                 dt: float):
    """The tick up to the contact solve: control wakes, narrow phase, touch
    events, impulse matching, islands, wake propagation, velocity
    integration and constraint setup.

    Returns (solve_args, carry): ``solve_args`` = (vc, man, pos, angle, vel,
    omega, active, link), what :func:`solve_contacts_plain` takes after the
    table; ``carry`` is what :func:`after_solve` needs besides."""
    dev = bodies.angle.device
    dyn = _const(~table.is_static, dev)[:, None]  # [B, 1]

    # -- control wakes (before the step, as the env calls happen pre-Step) --
    awake = bodies.awake | wake
    sleep_time = torch.where(wake & ~bodies.awake, 0.0, bodies.sleep_time)

    # -- contact update: skipped for pairs whose dynamic endpoints all sleep
    man_new = collide_all(table, bodies)
    awake_eff = awake | ~dyn
    ia = _const(table.pair_body_a.astype(np.int64), dev)
    ib = _const(table.pair_body_b.astype(np.int64), dev)
    upd = awake_eff[ia] | awake_eff[ib]  # [P, E]

    man = _select(upd, man_new, contacts.man)
    touching = torch.where(upd, man_new.count > 0, contacts.touching)
    begin = upd & touching & ~contacts.touching
    end = upd & ~touching & contacts.touching

    matched_n, matched_t = nph.match_impulses(
        man_new.ids.movedim(1, -1), contacts.man.ids.movedim(1, -1),
        contacts.normal_impulse.movedim(1, -1), contacts.tangent_impulse.movedim(1, -1),
    )
    upd2 = upd[:, None]
    matched_n = torch.where(upd2, matched_n.movedim(-1, 1), contacts.normal_impulse)
    matched_t = torch.where(upd2, matched_t.movedim(-1, 1), contacts.tangent_impulse)

    # -- islands + wake propagation ----------------------------------------
    labels = slv.compute_islands(table, touching)
    awake, sleep_time = slv.propagate_wake(table, labels, awake, sleep_time)
    active = awake & dyn

    # -- integrate velocities + damping (awake bodies only) ----------------
    # host float32 coefficients, rounded exactly as the JAX package rounds
    # them (numpy: f32(dt) * inv_mass in float32)
    f32 = np.float32
    dt_im = _const((dt * table.inv_mass).astype(f32), dev)[:, None, None]
    dt_ii = _const((dt * table.inv_inertia).astype(f32), dev)[:, None]
    lin_k = _const(np.clip(1.0 - dt * table.linear_damping, 0.0, 1.0).astype(f32), dev)
    ang_k = _const(np.clip(1.0 - dt * table.angular_damping, 0.0, 1.0).astype(f32), dev)
    vel_i = bodies.vel + dt_im * force
    omega_i = bodies.omega + dt_ii * torque
    vel = torch.where(active[:, None], vel_i * lin_k[:, None, None], bodies.vel)
    omega = torch.where(active, omega_i * ang_k[:, None], bodies.omega)

    # -- constraint setup; islands are made of touching dynamic-dynamic pairs
    vc = slv.init_velocity_constraints(
        table, man, bodies.pos, bodies.angle, vel, omega, matched_n, matched_t, active
    )
    both_dyn = _const(~table.is_static[table.pair_body_a] & ~table.is_static[table.pair_body_b],
                      dev)[:, None]
    solve_args = (vc, man, bodies.pos, bodies.angle, vel, omega, active, touching & both_dyn)
    carry = dict(labels=labels, awake=awake, sleep_time=sleep_time, matched_n=matched_n,
                 matched_t=matched_t, touching=touching, begin=begin, end=end)
    return solve_args, carry


def after_solve(table: ShapeTable, solve_args, carry, solved, dt: float):
    """The tick after the contact solve: sleep bookkeeping and the impulses
    stored for the next tick's warm start.  ``solved`` is what
    ``solve_contacts`` returned.  Returns (bodies, contacts, StepInfo)."""
    vc, man = solve_args[0], solve_args[1]
    vel, omega, pos, angle, n_imp, t_imp, pos_solved = solved

    # -- sleep bookkeeping (zeroes velocities of islands at rest) ----------
    awake, sleep_time, vel, omega = slv.update_sleep(
        table, carry["labels"], carry["awake"], carry["sleep_time"], vel, omega, dt, pos_solved
    )

    # -- store impulses for next-tick warm start (b2ContactSolver::
    # StoreImpulses; degraded second points keep their matched value) ------
    slot = torch.arange(2, device=angle.device)[None, :, None]
    live = vc.solve[:, None] & (slot < vc.count[:, None])
    stored_n = torch.where(live, n_imp, carry["matched_n"])
    stored_t = torch.where(live, t_imp, carry["matched_t"])

    touching = carry["touching"]
    new_contacts = Contacts(
        man=man, normal_impulse=stored_n, tangent_impulse=stored_t, touching=touching,
    )
    new_bodies = Bodies(
        pos=pos, angle=angle, vel=vel, omega=omega, awake=awake, sleep_time=sleep_time
    )
    return new_bodies, new_contacts, StepInfo(touching=touching, begin=carry["begin"],
                                              end=carry["end"])


def solve_contacts_plain(table: ShapeTable, vc: slv.VelocityConstraints, man, bodies_pos,
                         bodies_angle, vel, omega, active, link, dt, vel_iters, pos_iters):
    """The contact solve in plain PyTorch: warm start, velocity iterations,
    position integration and position iterations, with cos/sin recomputed at
    every pair visit."""
    labels = slv.compute_islands(table, link)
    vel, omega = slv.warm_start(table, vc, vel, omega)
    vel, omega, vc = slv.solve_velocity_constraints(table, vc, vel, omega, vel_iters)
    pos, angle, vel, omega = slv.integrate_positions(
        bodies_pos, bodies_angle, vel, omega, dt, active)
    pos, angle, island_done = slv.solve_position_constraints(
        table, man, pos, angle, pos_iters, vc.solve, labels)
    dyn = torch.as_tensor(np.asarray(~table.is_static), device=labels.device)[:, None]
    position_solved = torch.gather(island_done, 0, labels) & dyn
    return vel, omega, pos, angle, vc.normal_impulse, vc.tangent_impulse, position_solved


def step(table: ShapeTable, bodies: Bodies, contacts: Contacts, force, torque, wake,
         dt: float, velocity_iters: int, position_iters: int):
    """One physics tick for a batch of envs, all of it plain PyTorch ops.

    ``force`` [B, 2, E] / ``torque`` [B, E] are this tick's accumulators;
    ``wake`` [B, E] bool marks bodies the controls woke.  Returns
    (bodies, contacts, StepInfo)."""
    solve_args, carry = before_solve(table, bodies, contacts, force, torque, wake, dt)
    solved = solve_contacts_plain(table, *solve_args, dt, velocity_iters, position_iters)
    return after_solve(table, solve_args, carry, solved, dt)
