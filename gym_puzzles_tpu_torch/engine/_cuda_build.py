"""What the hand-written CUDA kernels' wrappers share: the build, the
binding, the world table and the launch counts.

* Build: one ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` per
  kernel source into a shared library with a plain C interface, at first
  use, into ``_build/`` beside this package (listed in ``.gitignore``),
  keyed by a hash of the sources and flags (:func:`build_library`, which
  the host rasterizer's g++ build shares).
* Binding: ``ctypes``; pointers and the stream go as ``c_void_p``.  A kernel
  runs on ``torch.cuda.current_stream()``; its C function returns
  ``cudaGetLastError()`` and the wrapper raises when it is not 0.
* The static world (:class:`ShapeTable`) goes into ``__constant__`` memory
  as ``struct World`` of ``csrc/tick.cuh``.  Each kernel's library has its
  own copy of that symbol and its own ``gpt_set_world``; a table is copied
  again only when it changes.  The copy is from pageable host memory, which
  a CUDA graph cannot capture: a graph's warm-up uploads its table, and
  before each replay ``utils/cuda_graph.py`` calls :meth:`CudaKernel.set_world`
  with the graph's table, which copies it again only if another table was
  uploaded since (two envs of different worlds replayed in turn each run on
  their own table).  That keeps the kernels' device code as it is.
* Size classes: each kernel is instantiated for a few ceilings of the body
  and pair counts (``SIZE_CLASSES``, the ``GPT_SMALL_*`` / ``GPT_LARGE_*`` of
  ``csrc/tick.cuh``); :func:`size_class` picks the smallest a table fits,
  and the launch passes its index.
* Each :class:`CudaKernel` (and :class:`PlainKernel`, a kernel with no
  world table) counts its launches; :func:`launch_count` reads a count by the
  kernel's name.  A launch captured into a CUDA graph counts
  once per replay: the graph records how many launches of each kernel it
  holds, takes its capture out of the counts, and adds them at each replay.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from gym_puzzles_tpu_torch.engine import narrowphase as nph
from gym_puzzles_tpu_torch.engine import shapes as shp
from gym_puzzles_tpu_torch.engine import solver as slv
from gym_puzzles_tpu_torch.engine.types import ShapeTable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEADERS = ("tick.cuh",)  # included by every kernel source

# compile-time maxima of csrc/tick.cuh
MAX_B, MAX_F, MAX_P, MAX_V = 16, 32, 64, shp.MAX_POLYGON_VERTICES
# (bodies, pairs) ceilings of the kernels' instantiations, smallest first
SIZE_CLASSES = ((8, 24), (MAX_B, MAX_P))

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
    """The kernels' view of a static table.  Raises ValueError for a table
    beyond the kernels' compile-time maxima."""
    B, F, P = table.num_bodies, table.num_fixtures, table.num_pairs
    if B > MAX_B or F > MAX_F or P > MAX_P:
        raise ValueError(
            f"table has {B} bodies, {F} fixtures, {P} pairs; the CUDA kernels "
            f"take at most {MAX_B}, {MAX_F}, {MAX_P}"
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


def size_class(table: ShapeTable) -> int:
    """Index into ``SIZE_CLASSES`` of the smallest instantiation whose
    per-env arrays hold ``table``.  Raises ValueError for a table beyond
    every class (as :func:`world_struct` does)."""
    B, P = table.num_bodies, table.num_pairs
    for index, (max_b, max_p) in enumerate(SIZE_CLASSES):
        if B <= max_b and P <= max_p:
            return index
    raise ValueError(f"table has {B} bodies and {P} pairs; the CUDA kernels "
                     f"take at most {MAX_B} and {MAX_P}")


def live_pairs(table: ShapeTable, bodies, contacts, force, torque, wake, dt) -> torch.Tensor:
    """[P, E] bool: the pairs whose rows kernel A's sweeps visit in a tick
    from these inputs, those solved with an effective point (the
    constraints of ``world.before_solve``: ``solve & count > 0``)."""
    from gym_puzzles_tpu_torch.engine import world  # world imports this module

    vc = world.before_solve(table, bodies, contacts, force, torque, wake, dt)[0][0]
    return vc.solve & (vc.count > 0)


def live_pair_stats(live: torch.Tensor, envs_per_warp: int) -> dict:
    """What bounds a sweep's length, from ``live`` [P, E] (the pairs a
    kernel's sweeps visit): the mean live pairs per env, and the mean over
    warps of the most any env of the warp has (a warp runs as long as its
    most loaded env)."""
    per_env = live.sum(dim=0).to(torch.float32)
    E = per_env.shape[0]
    pad = (-E) % envs_per_warp
    warps = torch.cat([per_env, per_env.new_zeros(pad)]).view(-1, envs_per_warp)
    return dict(mean=float(per_env.mean()), warp_max=float(warps.amax(dim=1).mean()),
                max=float(per_env.max()), envs_per_warp=envs_per_warp)


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def build_library(name: str, cmd: list, sources: list, key: str,
                  build_dir: Path = BUILD_DIR) -> tuple[Path, str]:
    """``cmd + ["-o", <library>, sources[0]]`` into ``<build_dir>/<name>_<hash>.so``,
    the hash taken over ``key`` (the flags) and the bytes of every source
    (``sources[0]`` and the headers it includes), unless that library
    exists.  Returns (library path, the compiler's output); raises with the
    compiler's output when it fails."""
    digest = hashlib.sha1(key.encode())
    for path in sources:
        digest.update(Path(path).read_bytes())
    lib = Path(build_dir) / f"{name}_{digest.hexdigest()[:16]}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp), str(sources[0])], capture_output=True,
                          text=True, check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib, log


def build_plain(name: str, source: str, build_dir: Path = BUILD_DIR) -> tuple[Path, str]:
    """A kernel source with a plain C interface and no world table, built
    with the kernels' flags (:func:`build_library`)."""
    return build_library(name, [_nvcc(), *NVCC_FLAGS], [CSRC / source], " ".join(NVCC_FLAGS),
                         build_dir)


def load_plain(name: str, source: str, functions: dict, build_dir: Path = BUILD_DIR):
    """:func:`build_plain`, loaded (the span stamp of ``utils/profiling.py``);
    ``functions`` maps each C function's name to (argtypes, restype)."""
    path, _log = build_plain(name, source, build_dir)
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in functions.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


KERNELS: dict[str, "CudaKernel | PlainKernel"] = {}


class PlainKernel:
    """A kernel source with a plain C interface and no world table
    (:func:`load_plain`; the learner's ``csrc/adam_fused.cu`` and
    ``csrc/mlp_grad.cu``, the v0 env's ``csrc/env_v0.cu``) whose launches
    are counted as a :class:`CudaKernel`'s: :func:`launch_count` reads them,
    and a CUDA graph adds the launches it captured at each replay.  Its
    wrapper calls the C function and adds to :attr:`launches`.  Kernels of
    one source that are counted apart name the same ``library``: it is built
    once."""

    def __init__(self, name: str, source: str, functions: dict, library: str | None = None):
        self.name, self.source, self.functions = name, source, functions
        self.library = library or name
        self.lib = None
        self.launches = 0
        self._lock = threading.Lock()
        KERNELS[name] = self

    def build(self, build_dir: Path = BUILD_DIR) -> tuple[Path, str]:
        return build_plain(self.library, self.source, build_dir)

    def load(self):
        with self._lock:
            if self.lib is None:
                self.lib = load_plain(self.library, self.source, self.functions)
        return self.lib


class CudaKernel:
    """One kernel source: its build, its loaded library, the table last
    copied to each device's constant memory, and the count of its launches.
    ``defines`` are ``-D`` options of its nvcc command (the builds that
    ``bench_kernels.py`` compares; the port's own kernels take none)."""

    def __init__(self, name: str, source: str, entry: str, argtypes: list,
                 defines: tuple = ()):
        self.name, self.source, self.entry, self.argtypes = name, source, entry, argtypes
        self.defines = tuple(defines)
        self.lib = None
        self.uploaded = {}  # device index -> (table, World kept alive)
        self.launches = 0
        self._lock = threading.Lock()
        KERNELS[name] = self

    def build(self, build_dir: Path = BUILD_DIR) -> tuple[Path, str]:
        """Compile the source for sm_90a into a shared library, unless a
        build of the same sources and flags exists.  Returns (library path,
        the compiler's output -- ptxas registers, stack frame and spills)."""
        flags = NVCC_FLAGS + tuple(f"-D{d}" for d in self.defines)
        sources = [CSRC / self.source] + [CSRC / h for h in HEADERS]
        return build_library(self.name, [_nvcc(), *flags], sources, " ".join(flags), build_dir)

    def load(self):
        with self._lock:
            if self.lib is None:
                path, _log = self.build()
                lib = ctypes.CDLL(str(path))
                vp = ctypes.c_void_p
                lib.gpt_set_world.argtypes = [vp, vp]
                lib.gpt_set_world.restype = _c_int
                lib.gpt_envs_per_warp.argtypes = []
                lib.gpt_envs_per_warp.restype = _c_int
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = _c_int
                check_library(lib)
                self.lib = lib
        return self.lib

    def envs_per_warp(self) -> int:
        """How many envs one warp of this build runs (``GPT_ENVS_PER_WARP``)."""
        return self.load().gpt_envs_per_warp()

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

    def launch(self, table: ShapeTable, device: torch.device, *args):
        """Copy ``table`` if it changed, call the entry point with ``args``
        and the current stream of ``device``, raise on a CUDA error, and
        count the launch."""
        lib = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            self.set_world(table, device, stream)
            err = getattr(lib, self.entry)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        self.launches += 1


def check_library(lib):
    """Raise unless a kernel library (device or host build) lays out
    ``World`` and numbers its size classes as this module does."""
    lib.gpt_world_bytes.argtypes = []
    lib.gpt_world_bytes.restype = _c_int
    lib.gpt_size_classes.argtypes = [ctypes.POINTER(_c_int)]
    lib.gpt_size_classes.restype = _c_int
    if lib.gpt_world_bytes() != ctypes.sizeof(World):
        raise RuntimeError("csrc/tick.cuh World and _cuda_build.World disagree")
    out = (_c_int * 4)()
    n = lib.gpt_size_classes(out)
    if tuple(zip(out[0:2 * n:2], out[1:2 * n:2])) != SIZE_CLASSES:
        raise RuntimeError("csrc/tick.cuh size classes and _cuda_build.SIZE_CLASSES disagree")


def ptxas_report(log: str) -> list[dict]:
    """Per kernel instantiation in an nvcc ``-Xptxas -v`` log: its size class
    (the template's body and pair ceilings), registers, stack frame and spill
    bytes."""
    out, current = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            t = re.search(r"ILi(\d+)ELi(\d+)E", m.group(1))
            current = dict(function=m.group(1), bodies=int(t.group(1)) if t else None,
                           pairs=int(t.group(2)) if t else None)
            out.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return [r for r in out if r["bodies"] is not None]


def launch_count(name: str) -> int:
    """Launches of the kernel ``name`` in this process."""
    return KERNELS[name].launches


def reset_launch_counts():
    for kernel in KERNELS.values():
        kernel.launches = 0


def check_planes(kernel: str, device: torch.device, planes):
    """Raise unless each (name, tensor, dtype, shape) is a contiguous tensor
    of that dtype and shape on ``device``, which must be a CUDA device."""
    if device.type != "cuda":
        raise ValueError(f"the {kernel} kernel takes CUDA tensors, got {device}")
    for name, x, dtype, shape in planes:
        if (x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous()
                or x.device != device):
            raise ValueError(f"{name}: expected contiguous {dtype} {list(shape)} on {device}, "
                             f"got {x.dtype} {list(x.shape)} on {x.device}")
