"""Fused whole-tick CUDA kernel: its build, its binding and its wrapper.

Port of ``gym_puzzles_tpu/engine/step_pallas.py::step_fused``.  The kernel
(``csrc/step_fused.cu`` with the solve phases in ``csrc/tick.cuh``) runs one
whole engine tick per env -- narrow phase through sleep -- in one launch, one
thread per env; its sweeps visit only each env's live pairs.

* Build, binding, the world table in ``__constant__`` memory and the launch
  count: ``engine/_cuda_build.py``, shared with the staged solve kernel
  (``engine/solver_cuda.py``).
* Plane layout: the JAX kernel's (``step_pallas.py:81-95``), env axis last.
* The launch picks the kernel's instantiation from the table
  (``_cuda_build.size_class``).

:func:`step_fused` launches the kernel for CUDA tensors (or raises); for CPU
tensors it runs the plain version, ``world.step``.  Nothing on the GPU path
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.engine import narrowphase as nph
from gym_puzzles_tpu_torch.engine import world as eng
from gym_puzzles_tpu_torch.engine.types import Bodies, Contacts, ShapeTable
from gym_puzzles_tpu_torch.utils.profiling import device_span

# body f32 input planes (indices into bf, stride B), then output planes
B_IN = ("velx", "vely", "om", "posx", "posy", "ang",
        "awake", "sleep", "wake", "fx", "fy", "tq")
B_OUT = ("velx", "vely", "om", "posx", "posy", "ang", "awake", "sleep")
# pair f32 input planes (stride P); the outputs add begin/end.  Packed int32
# contact ids travel in their own [2P, E] plane block (p*2 + j).
P_IN = ("flip", "lnx", "lny", "lpx", "lpy",
        "mpx0", "mpy0", "mpx1", "mpy1", "mcnt", "touch",
        "ni0", "ni1", "ti0", "ti1")
P_OUT = P_IN + ("begin", "end")

_vp, _int = ctypes.c_void_p, ctypes.c_int
KERNEL = cb.CudaKernel(
    "step_fused", "step_fused.cu", "gpt_step_fused",
    [_vp] * 6 + [_int, ctypes.c_float, _int, _int, _int, _int, _vp])


def launch_count(name: str = "step_fused") -> int:
    """Launches of a CUDA kernel in this process, by kernel name
    (``'step_fused'`` or ``'solve_contacts'``)."""
    return cb.launch_count(name)


def reset_launch_count():
    """Set every kernel's launch count to 0."""
    cb.reset_launch_counts()


# --------------------------------------------------------------------------
# Planes
# --------------------------------------------------------------------------


def pack(bodies: Bodies, contacts: Contacts, force, torque, wake):
    """State -> the kernel's input planes: bf [12B, E] f32, pf [15P, E] f32,
    pi [2P, E] int32 (step_pallas.py:883-898)."""
    f32 = lambda x: x.to(torch.float32)
    man = contacts.man
    bf = torch.cat([
        bodies.vel[:, 0], bodies.vel[:, 1], bodies.omega,
        bodies.pos[:, 0], bodies.pos[:, 1], bodies.angle,
        f32(bodies.awake), bodies.sleep_time, f32(wake),
        force[:, 0], force[:, 1], torque,
    ])
    pf = torch.cat([
        f32(man.flip), man.local_normal[:, 0], man.local_normal[:, 1],
        man.local_point[:, 0], man.local_point[:, 1],
        man.points[:, 0, 0], man.points[:, 0, 1],
        man.points[:, 1, 0], man.points[:, 1, 1],
        f32(man.count), f32(contacts.touching),
        contacts.normal_impulse[:, 0], contacts.normal_impulse[:, 1],
        contacts.tangent_impulse[:, 0], contacts.tangent_impulse[:, 1],
    ])
    P, E = man.count.shape
    pi = man.ids.reshape(2 * P, E).to(torch.int32)
    return bf.contiguous(), pf.contiguous(), pi.contiguous()


def unpack(table: ShapeTable, bfo, pfo, pio):
    """The kernel's output planes -> (Bodies, Contacts, StepInfo)
    (step_pallas.py:943-985)."""
    B, P = table.num_bodies, table.num_pairs
    E = bfo.shape[-1]
    bo = bfo.view(len(B_OUT), B, E)
    po = pfo.view(len(P_OUT), P, E)
    o = {n: bo[i] for i, n in enumerate(B_OUT)}
    q = {n: po[i] for i, n in enumerate(P_OUT)}
    bodies = Bodies(
        pos=torch.stack([o["posx"], o["posy"]], dim=1),
        angle=o["ang"],
        vel=torch.stack([o["velx"], o["vely"]], dim=1),
        omega=o["om"],
        awake=o["awake"] > 0.5,
        sleep_time=o["sleep"],
    )
    touching = q["touch"] > 0.5
    man = nph.Manifold(
        flip=q["flip"] > 0.5,
        local_normal=torch.stack([q["lnx"], q["lny"]], dim=1),
        local_point=torch.stack([q["lpx"], q["lpy"]], dim=1),
        points=torch.stack([torch.stack([q["mpx0"], q["mpy0"]], dim=1),
                            torch.stack([q["mpx1"], q["mpy1"]], dim=1)], dim=1),
        ids=pio.view(P, 2, E),
        count=q["mcnt"].to(torch.int32),
    )
    contacts = Contacts(
        man=man,
        normal_impulse=torch.stack([q["ni0"], q["ni1"]], dim=1),
        tangent_impulse=torch.stack([q["ti0"], q["ti1"]], dim=1),
        touching=touching,
    )
    info = eng.StepInfo(touching=touching, begin=q["begin"] > 0.5, end=q["end"] > 0.5)
    return bodies, contacts, info


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------


def launch(table: ShapeTable, bf, pf, pi, dt: float, vel_iters: int, pos_iters: int,
           incremental_trig: bool = True):
    """Run the kernel on packed planes; returns the output planes
    (bfo [8B, E], pfo [17P, E], pio [2P, E])."""
    B, P = table.num_bodies, table.num_pairs
    E = bf.shape[-1]
    dev = bf.device
    cb.check_planes("fused tick", dev, (("bf", bf, torch.float32, (len(B_IN) * B, E)),
                                        ("pf", pf, torch.float32, (len(P_IN) * P, E)),
                                        ("pi", pi, torch.int32, (2 * P, E))))
    if not math.isfinite(dt) or vel_iters < 0 or pos_iters < 0:
        raise ValueError(f"bad tick parameters dt={dt} iters={vel_iters}/{pos_iters}")
    bfo = torch.empty((len(B_OUT) * B, E), dtype=torch.float32, device=dev)
    pfo = torch.empty((len(P_OUT) * P, E), dtype=torch.float32, device=dev)
    pio = torch.empty((2 * P, E), dtype=torch.int32, device=dev)
    KERNEL.launch(table, dev, bf.data_ptr(), pf.data_ptr(), pi.data_ptr(), bfo.data_ptr(),
                  pfo.data_ptr(), pio.data_ptr(), E, float(dt), int(vel_iters),
                  int(pos_iters), int(bool(incremental_trig)), cb.size_class(table))
    return bfo, pfo, pio


def step_fused(table: ShapeTable, bodies: Bodies, contacts: Contacts, force, torque, wake,
               dt, vel_iters, pos_iters, incremental_trig: bool = True):
    """Batched engine tick.  Same contract as ``world.step``: every tensor
    carries the env batch on its last axis; returns (Bodies, Contacts,
    StepInfo).

    On CUDA tensors the whole tick is one launch of the fused kernel.  The
    position pass advances cached rotations by a 5th-order small-angle step
    (``incremental_trig=True``, the production default) or recomputes
    cos/sin at every pair visit as ``world.step`` does (False).  On CPU
    tensors this is the plain ``world.step`` (which recomputes).  The device
    span ``env.tick`` (``utils/profiling.py``) holds the kernel's launch, or
    the plain tick: not the planes' packing around it."""
    dev = bodies.angle.device
    if dev.type == "cpu":
        with device_span("env.tick", dev):
            return eng.step(table, bodies, contacts, force, torque, wake,
                            dt, vel_iters, pos_iters)
    bf, pf, pi = pack(bodies, contacts, force, torque, wake)
    with device_span("env.tick", dev):
        bfo, pfo, pio = launch(table, bf, pf, pi, dt, vel_iters, pos_iters, incremental_trig)
    return unpack(table, bfo, pfo, pio)
