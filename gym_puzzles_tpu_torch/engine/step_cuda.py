"""Fused whole-tick CUDA kernel: its build, its binding and its wrapper.

Port of ``gym_puzzles_tpu/engine/step_pallas.py::step_fused``.  The kernel
(``csrc/step_fused.cu`` with the solve phases in ``csrc/tick.cuh``) runs one
whole engine tick per env -- narrow phase through sleep -- in one launch, one
thread per env.

* Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into a
  shared library with a plain C interface, at first use, into ``_build/``
  beside this package (listed in ``.gitignore``), keyed by a hash of the
  sources and flags.
* Binding: ``ctypes``; pointers and the stream go as ``c_void_p``.  The
  kernel runs on ``torch.cuda.current_stream()``; the C function returns
  ``cudaGetLastError()`` and the wrapper raises when it is not 0.
* The static world (:class:`ShapeTable`) goes into ``__constant__`` memory,
  copied again only when the table changes.
* Plane layout: the JAX kernel's (``step_pallas.py:81-95``), env axis last.

:func:`step_fused` launches the kernel for CUDA tensors (or raises); for CPU
tensors it runs the plain version, ``world.step``.  Nothing on the GPU path
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from gym_puzzles_tpu_torch.engine import narrowphase as nph
from gym_puzzles_tpu_torch.engine import shapes as shp
from gym_puzzles_tpu_torch.engine import solver as slv
from gym_puzzles_tpu_torch.engine import world as eng
from gym_puzzles_tpu_torch.engine.types import Bodies, Contacts, ShapeTable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("step_fused.cu", "tick.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# compile-time maxima of csrc/tick.cuh
MAX_B, MAX_F, MAX_P, MAX_V = 16, 32, 64, shp.MAX_POLYGON_VERTICES

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

_c_int, _c_float = ctypes.c_int, ctypes.c_float


class World(ctypes.Structure):
    """ctypes mirror of ``struct World`` in csrc/tick.cuh."""

    _fields_ = [
        ("B", _c_int), ("F", _c_int), ("P", _c_int), ("n_dyn", _c_int), ("n_dd", _c_int),
        ("dyn", _c_int * MAX_B), ("dyn_bodies", _c_int * MAX_B),
        ("inv_m", _c_float * MAX_B), ("inv_i", _c_float * MAX_B),
        ("lcx", _c_float * MAX_B), ("lcy", _c_float * MAX_B),
        ("lin_damp", _c_float * MAX_B), ("ang_damp", _c_float * MAX_B),
        ("fix_count", _c_int * MAX_F),
        ("fix_verts", _c_float * (MAX_F * MAX_V * 2)),
        ("fix_normals", _c_float * (MAX_F * MAX_V * 2)),
        ("ia", _c_int * MAX_P), ("ib", _c_int * MAX_P),
        ("fa", _c_int * MAX_P), ("fb", _c_int * MAX_P),
        ("rep", _c_int * MAX_P), ("dd_pairs", _c_int * MAX_P),
        ("fric", _c_float * MAX_P), ("rest", _c_float * MAX_P), ("m_sum", _c_float * MAX_P),
    ] + [(name, _c_float) for name in (
        "total_radius", "clip_tol", "polygon_radius", "linear_slop", "baumgarte",
        "max_linear_correction", "max_translation", "max_translation_sq",
        "max_rotation", "max_rotation_sq", "velocity_threshold", "max_condition",
        "lin_sleep_tol_sq", "ang_sleep_tol_sq", "time_to_sleep", "pos_done_sep",
        "rot_c2", "rot_c4", "rot_s3", "rot_s5",
    )]


def world_struct(table: ShapeTable) -> World:
    """The kernel's view of a static table.  Raises ValueError for a table
    beyond the kernel's compile-time maxima."""
    B, F, P = table.num_bodies, table.num_fixtures, table.num_pairs
    if B > MAX_B or F > MAX_F or P > MAX_P:
        raise ValueError(
            f"table has {B} bodies, {F} fixtures, {P} pairs; the fused kernel "
            f"takes at most {MAX_B}, {MAX_F}, {MAX_P}"
        )
    dyn = ~table.is_static
    w = World()
    w.B, w.F, w.P = B, F, P
    dyn_bodies = [b for b in range(B) if dyn[b]]
    dd = [p for _a, _b, p in slv.dd_links(table)]
    w.n_dyn, w.n_dd = len(dyn_bodies), len(dd)

    def fill(field, values):
        arr = getattr(w, field)
        for i, v in enumerate(values):
            arr[i] = v

    fill("dyn", [int(d) for d in dyn])
    fill("dyn_bodies", dyn_bodies)
    fill("inv_m", table.inv_mass)
    fill("inv_i", table.inv_inertia)
    fill("lcx", table.local_center[:, 0])
    fill("lcy", table.local_center[:, 1])
    fill("lin_damp", table.linear_damping)
    fill("ang_damp", table.angular_damping)
    fill("fix_count", table.fix_count)
    verts = np.zeros((MAX_F, MAX_V, 2), np.float32)
    normals = np.zeros((MAX_F, MAX_V, 2), np.float32)
    verts[:F], normals[:F] = table.fix_verts, table.fix_normals
    fill("fix_verts", verts.reshape(-1))
    fill("fix_normals", normals.reshape(-1))
    pa, pb = table.pair_body_a, table.pair_body_b
    fill("ia", pa)
    fill("ib", pb)
    fill("fa", table.pair_fix_a)
    fill("fb", table.pair_fix_b)
    fill("rep", [int(pa[p]) if dyn[pa[p]] else int(pb[p]) for p in range(P)])
    fill("dd_pairs", dd)
    fill("fric", table.pair_friction)
    fill("rest", table.pair_restitution)
    fill("m_sum", (table.inv_mass[pa] + table.inv_mass[pb]).astype(np.float32))
    # the plain version's Python-float constants, rounded to float32 as
    # PyTorch rounds a Python scalar against a float32 tensor
    consts = dict(
        total_radius=nph.TOTAL_RADIUS, clip_tol=nph.CLIP_TOL,
        polygon_radius=shp.POLYGON_RADIUS, linear_slop=shp.LINEAR_SLOP,
        baumgarte=slv.BAUMGARTE, max_linear_correction=slv.MAX_LINEAR_CORRECTION,
        max_translation=slv.MAX_TRANSLATION, max_translation_sq=slv.MAX_TRANSLATION**2,
        max_rotation=slv.MAX_ROTATION, max_rotation_sq=slv.MAX_ROTATION**2,
        velocity_threshold=slv.VELOCITY_THRESHOLD, max_condition=slv.MAX_CONDITION_NUMBER,
        lin_sleep_tol_sq=slv.LINEAR_SLEEP_TOL_SQ, ang_sleep_tol_sq=slv.ANGULAR_SLEEP_TOL_SQ,
        time_to_sleep=slv.TIME_TO_SLEEP, pos_done_sep=-3.0 * shp.LINEAR_SLOP,
        rot_c2=0.5, rot_c4=1.0 / 24.0, rot_s3=1.0 / 6.0, rot_s5=1.0 / 120.0,
    )
    for name, value in consts.items():
        setattr(w, name, float(np.float32(value)))
    return w


# --------------------------------------------------------------------------
# Build and binding
# --------------------------------------------------------------------------


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the fused tick kernel is built with the CUDA toolkit")


def build(build_dir: Path = BUILD_DIR) -> tuple[Path, str]:
    """Compile ``csrc/step_fused.cu`` for sm_90a into a shared library, unless
    a build of the same sources and flags exists.  Returns (library path,
    the compiler's output -- ptxas registers, stack frame and spills)."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    lib = Path(build_dir) / f"step_fused_{digest.hexdigest()[:16]}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "step_fused.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib, log


class _Kernel:
    """The loaded library, the table last copied to each device's constant
    memory, and the count of kernel launches."""

    def __init__(self):
        self.lib = None
        self.uploaded = {}  # device index -> (table id, World kept alive)
        self.launches = 0
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self.lib is None:
                path, _log = build()
                lib = ctypes.CDLL(str(path))
                vp = ctypes.c_void_p
                lib.gpt_world_bytes.argtypes = []
                lib.gpt_world_bytes.restype = _c_int
                lib.gpt_set_world.argtypes = [vp, vp]
                lib.gpt_set_world.restype = _c_int
                lib.gpt_step_fused.argtypes = [vp, vp, vp, vp, vp, vp, _c_int, _c_float,
                                               _c_int, _c_int, _c_int, vp]
                lib.gpt_step_fused.restype = _c_int
                if lib.gpt_world_bytes() != ctypes.sizeof(World):
                    raise RuntimeError("csrc/tick.cuh World and step_cuda.World disagree")
                self.lib = lib
        return self.lib

    def set_world(self, table: ShapeTable, device: torch.device, stream: int):
        index = device.index if device.index is not None else torch.cuda.current_device()
        held = self.uploaded.get(index)
        if held is not None and held[0] is table:
            return
        w = world_struct(table)
        err = self.lib.gpt_set_world(ctypes.byref(w), stream)
        if err != 0:
            raise RuntimeError(f"copying the world table to the card failed: CUDA error {err}")
        self.uploaded[index] = (table, w)


KERNEL = _Kernel()


def launch_count() -> int:
    """Launches of the fused tick kernel in this process."""
    return KERNEL.launches


def reset_launch_count():
    KERNEL.launches = 0


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
    if dev.type != "cuda":
        raise ValueError(f"the fused tick kernel takes CUDA tensors, got {dev}")
    for name, x, dtype, rows in (("bf", bf, torch.float32, len(B_IN) * B),
                                 ("pf", pf, torch.float32, len(P_IN) * P),
                                 ("pi", pi, torch.int32, 2 * P)):
        if x.dtype != dtype or x.shape != (rows, E) or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name}: expected contiguous {dtype} [{rows}, {E}] on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not math.isfinite(dt) or vel_iters < 0 or pos_iters < 0:
        raise ValueError(f"bad tick parameters dt={dt} iters={vel_iters}/{pos_iters}")
    lib = KERNEL.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.set_world(table, dev, stream)
        bfo = torch.empty((len(B_OUT) * B, E), dtype=torch.float32, device=dev)
        pfo = torch.empty((len(P_OUT) * P, E), dtype=torch.float32, device=dev)
        pio = torch.empty((2 * P, E), dtype=torch.int32, device=dev)
        err = lib.gpt_step_fused(bf.data_ptr(), pf.data_ptr(), pi.data_ptr(), bfo.data_ptr(),
                                 pfo.data_ptr(), pio.data_ptr(), E, float(dt), int(vel_iters),
                                 int(pos_iters), int(bool(incremental_trig)), stream)
    if err != 0:
        raise RuntimeError(f"fused tick kernel launch failed: CUDA error {err}")
    KERNEL.launches += 1
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
    tensors this is the plain ``world.step`` (which recomputes)."""
    if bodies.angle.device.type == "cpu":
        return eng.step(table, bodies, contacts, force, torque, wake,
                        dt, vel_iters, pos_iters)
    bf, pf, pi = pack(bodies, contacts, force, torque, wake)
    bfo, pfo, pio = launch(table, bf, pf, pi, dt, vel_iters, pos_iters, incremental_trig)
    return unpack(table, bfo, pfo, pio)
