"""Staged contact-solve CUDA kernel: its wrapper and its plain version.

Port of ``gym_puzzles_tpu/engine/solver_pallas.py::solve_contacts``.  The
kernel (``csrc/solve_contacts.cu``, with the solve phases of
``csrc/tick.cuh`` that the fused tick kernel also calls) runs the whole
sequential-impulse solve of one tick per env in one launch, one thread per
env: warm start, velocity sweeps, clamped position integration, position
sweeps with the per-island early exit, each sweep over the env's live pairs
only.  ``world.step_batched`` runs the
narrow phase, islands, constraint setup and sleep bookkeeping around it as
plain PyTorch ops.

* Build, binding, world table and launch count: ``engine/_cuda_build.py``.
  This kernel is a shared library of its own, with its own copy of the world
  table in ``__constant__`` memory.
* Plane layout: the JAX kernel's (``solver_pallas.py:79-83, 718-746``), env
  axis last; any number of envs.
* The launch picks the kernel's instantiation from the table
  (``_cuda_build.size_class``).

:func:`solve_contacts` launches the kernel for CUDA tensors (or raises); for
CPU tensors it runs :func:`solve_contacts_plain`.  Nothing on the GPU path
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.engine import solver as slv
from gym_puzzles_tpu_torch.engine.types import ShapeTable

# per-pair planes (stride P), per-pair-point planes (stride 2P), body planes
PA = ("nx", "ny", "k11", "k12", "k22", "im11", "im12", "im22",
      "cnt", "solve", "flip", "lnx", "lny", "lpx", "lpy", "link", "mcnt")
PB = ("bias", "nmass", "tmass", "rax", "ray", "rbx", "rby", "mpx", "mpy")
BODY = ("velx", "vely", "om", "posx", "posy", "ang")

_vp, _int = ctypes.c_void_p, ctypes.c_int
KERNEL = cb.CudaKernel(
    "solve_contacts", "solve_contacts.cu", "gpt_solve_contacts",
    [_vp] * 8 + [_int, ctypes.c_float, _int, _int, _int, _int, _vp])


def pack(vc: slv.VelocityConstraints, man, bodies_pos, bodies_angle, vel, omega, active, link):
    """Constraints and body state -> the kernel's input planes: pair_a
    [17P, E], pair_b [18P, E], active [B, E], body [6B, E], imp [4P, E], all
    float32 (solver_pallas.py:718-746)."""
    f32 = lambda x: x.to(torch.float32)
    P, E = vc.k11.shape
    pts = lambda x: x.reshape(2 * P, E)  # [P, 2, E] -> [2P, E], pair-major
    pair_a = torch.cat([
        vc.normal[:, 0], vc.normal[:, 1],
        vc.k11, vc.k12, vc.k22, vc.im11, vc.im12, vc.im22,
        f32(vc.count), f32(vc.solve),
        f32(man.flip),
        man.local_normal[:, 0], man.local_normal[:, 1],
        man.local_point[:, 0], man.local_point[:, 1],
        f32(link),
        f32(man.count),
    ])
    pair_b = torch.cat([
        pts(vc.bias), pts(vc.normal_mass), pts(vc.tangent_mass),
        pts(vc.r_a[:, :, 0]), pts(vc.r_a[:, :, 1]),
        pts(vc.r_b[:, :, 0]), pts(vc.r_b[:, :, 1]),
        pts(man.points[:, :, 0]), pts(man.points[:, :, 1]),
    ])
    body = torch.cat([vel[:, 0], vel[:, 1], omega,
                      bodies_pos[:, 0], bodies_pos[:, 1], bodies_angle])
    imp = torch.cat([pts(vc.normal_impulse), pts(vc.tangent_impulse)])
    return (pair_a.contiguous(), pair_b.contiguous(), f32(active).contiguous(),
            body.contiguous(), imp.contiguous())


def unpack(table: ShapeTable, body, imp, done):
    """The kernel's output planes -> (vel, omega, pos, angle, normal_impulse,
    tangent_impulse, position_solved) (solver_pallas.py:813-823)."""
    B, P = table.num_bodies, table.num_pairs
    E = body.shape[-1]
    o = dict(zip(BODY, body.view(len(BODY), B, E)))
    vel = torch.stack([o["velx"], o["vely"]], dim=1)
    pos = torch.stack([o["posx"], o["posy"]], dim=1)
    n_imp = imp[: 2 * P].view(P, 2, E)
    t_imp = imp[2 * P:].view(P, 2, E)
    return vel, o["om"], pos, o["ang"], n_imp, t_imp, done > 0.5


def launch(table: ShapeTable, pair_a, pair_b, active, body, imp, dt: float, vel_iters: int,
           pos_iters: int, incremental_trig: bool = True):
    """Run the kernel on packed planes; returns the output planes
    (body [6B, E], imp [4P, E], done [B, E])."""
    B, P = table.num_bodies, table.num_pairs
    E = body.shape[-1]
    dev = body.device
    f = torch.float32
    cb.check_planes("contact solve", dev, (
        ("pair_a", pair_a, f, (len(PA) * P, E)), ("pair_b", pair_b, f, (2 * len(PB) * P, E)),
        ("active", active, f, (B, E)), ("body", body, f, (len(BODY) * B, E)),
        ("imp", imp, f, (4 * P, E))))
    if not math.isfinite(dt) or vel_iters < 0 or pos_iters < 0:
        raise ValueError(f"bad solve parameters dt={dt} iters={vel_iters}/{pos_iters}")
    body_o, imp_o = torch.empty_like(body), torch.empty_like(imp)
    done_o = torch.empty((B, E), dtype=f, device=dev)
    KERNEL.launch(table, dev, pair_a.data_ptr(), pair_b.data_ptr(), active.data_ptr(),
                  body.data_ptr(), imp.data_ptr(), body_o.data_ptr(), imp_o.data_ptr(),
                  done_o.data_ptr(), E, float(dt), int(vel_iters), int(pos_iters),
                  int(bool(incremental_trig)), cb.size_class(table))
    return body_o, imp_o, done_o


def solve_contacts_plain(table: ShapeTable, vc: slv.VelocityConstraints, man, bodies_pos,
                         bodies_angle, vel, omega, active, link, dt, vel_iters, pos_iters,
                         incremental_trig: bool = True):
    """The plain PyTorch version of the kernel, composed from
    ``engine/solver.py``: same arguments, same seven outputs.  The position
    pass recomputes cos/sin at every pair visit whatever ``incremental_trig``
    says (the kernel's exact mode).

    The island labels are derived from ``link`` here, although the caller's
    prologue has labelled the same islands already: the JAX signature passes
    ``link`` and no labels, and the kernel derives them the same way."""
    del incremental_trig
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


def solve_contacts(table: ShapeTable, vc: slv.VelocityConstraints, man, bodies_pos,
                   bodies_angle, vel, omega, active, link, dt, vel_iters, pos_iters,
                   incremental_trig: bool = True):
    """Batched contact solve.  Every tensor carries the env batch on its
    last axis.  ``vc`` and ``man`` are this tick's constraints and manifolds,
    ``active`` [B, E] the awake dynamic bodies, ``link`` [P, E] the pairs
    that touch and join two dynamic bodies (what islands are made of).
    Returns (vel, omega, pos, angle, normal_impulse, tangent_impulse,
    position_solved [B, E] bool: the body's island converged; False for
    static bodies).

    On CUDA tensors the solve is one launch of the kernel.  The position
    pass advances cached rotations by a 5th-order small-angle step
    (``incremental_trig=True``, the production default) or recomputes
    cos/sin at every pair visit (False).  On CPU tensors this is
    :func:`solve_contacts_plain`."""
    if vel.device.type == "cpu":
        return solve_contacts_plain(table, vc, man, bodies_pos, bodies_angle, vel, omega,
                                    active, link, dt, vel_iters, pos_iters)
    planes = pack(vc, man, bodies_pos, bodies_angle, vel, omega, active, link)
    body, imp, done = launch(table, *planes, dt, vel_iters, pos_iters, incremental_trig)
    return unpack(table, body, imp, done)
