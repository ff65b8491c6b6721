"""The v0 env's per-step logic around the engine tick as two hand-written
CUDA kernels (``csrc/env_v0.cu``): their wrapper, layout and binding.

* :func:`control` (inside the device span ``env.control``) returns what
  ``V0Env._control_plain`` returns: the bodies with the agents' velocity and
  omega rows set from the action, the force (the block's soft force), the
  torque and the wake mask.
* :func:`score_respawn` (inside ``env.score``) returns what
  ``PuzzleEnvLogic._finish`` returns.  Given ``draws``, the spawn's uniforms
  (``V0Env._spawn_draws``, drawn for every env from the env's generator in
  ``env.autoreset``, as ``VectorEnv``'s plain autoreset draws them), it also
  does what that autoreset does: each env that is done or truncated comes
  back as the spawn its uniforms place, with that spawn's observation, while
  reward, done and info stay the step's.  Those envs' columns are written in
  place into the ticked state's tensors, which this step allocated (one that
  is not contiguous, or shares storage with the state before the step, is
  copied first); nothing is written over the other envs' state, and the
  fields that the plain version passes through (``goal_pos``) come back as
  new tensors, never written in place.
* Who takes them: ``V0Env`` (MultiRobotPuzzle-v0 and -Heavy-v0) with its state
  on a CUDA device (``V0Env.fused_logic``), both engine backends and the
  image env alike; ``reset_mode='reference'`` takes both with no respawn (its
  spawns step through the engine).  The CPU runs the plain ops, which the
  card's tests hold the kernels against; v2 and v3 never call this module.
  What the kernels do not take raises ``ValueError``: nothing falls back.
* Build, binding and launch counts: ``engine/_cuda_build.py``, one library
  and two :class:`~gym_puzzles_tpu_torch.engine._cuda_build.PlainKernel`
  counts (``v0_control``, ``v0_score_respawn``), a launch a call each.
* With tracing on, :func:`score_respawn` with ``draws`` passes the kernel the
  device counter of ``profiling.RESPAWNS`` (envs respawned, env-steps
  scored); with tracing off a null pointer, and the kernel counts nothing.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.engine.types import Bodies, Contacts
from gym_puzzles_tpu_torch.envs import common as cm
from gym_puzzles_tpu_torch.envs import config as C
from gym_puzzles_tpu_torch.envs.layout import BLOCK_SLOT, WALL_SLOTS
from gym_puzzles_tpu_torch.utils import cuda_graph as cg
from gym_puzzles_tpu_torch.utils import profiling

# csrc/env_v0.cu's GPT_V0_THREADS, GPT_V0_MAX_BODIES, GPT_V0_MAX_VERTS
THREADS, MAX_BODIES, MAX_VERTS = 128, 16, 8
# csrc/env_v0.cu's GPT_V0_WORLDS: the (agents, bodies) instantiated, v0 and Heavy-v0
WORLDS = ((2, 7), (5, 10))
# the planes' order of the C entries (csrc/env_v0.cu enum ControlPtr, ScorePtr)
CONTROL_PTRS = ("action", "pos", "vel", "omega", "agent_dist",
                "vel_out", "omega_out", "force", "torque", "wake")
SCORE_PTRS = ("pos", "angle", "goal_contact",
              "goal", "prev_agent_dist", "prev_block_distance", "prev_blks", "prev_t",
              "weight_delta_agent", "weight_agent_dist", "weight_delta_block", "weight_blk_dist",
              "u_bx", "u_by", "u_ang", "u_axy",
              "obs", "reward", "done", "truncated", "info_t", "info_status",
              "agent_dist", "block_distance", "block_angle", "blks", "t", "status", "goal_out",
              "vel", "omega", "awake", "sleep_time", "wall_contact",
              "flip", "local_normal", "local_point", "points", "ids", "count",
              "normal_impulse", "tangent_impulse", "touching",
              "counts")
# the RewardParams fields the reward reads, in csrc/env_v0.cu Weights' order
WEIGHTS = ("weight_delta_agent", "weight_agent_dist", "weight_delta_block", "weight_blk_dist")

_int, _float, _vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_LL = ctypes.POINTER(ctypes.c_longlong)


class Layout(ctypes.Structure):
    """ctypes mirror of ``struct Layout`` in csrc/env_v0.cu."""

    _fields_ = ([(n, _int) for n in ("P", "n_verts", "max_steps")]
                + [(n, _float) for n in ("scale", "speed", "two_pi", "epsilon", "ds",
                                         "block_reward", "final_reward", "contact_reward",
                                         "pow_base", "unit_floor")]
                + [("lcx", _float * MAX_BODIES), ("lcy", _float * MAX_BODIES),
                   ("wall_x", _float * len(WALL_SLOTS)), ("wall_y", _float * len(WALL_SLOTS)),
                   ("vert_x", _float * MAX_VERTS), ("vert_y", _float * MAX_VERTS),
                   ("goal", _float * 3), ("lo", _float * 5), ("range", _float * 5)])


_LAYOUT = ctypes.POINTER(Layout)
FUNCTIONS = {
    "gpt_v0_control": ([_int, _int, _LAYOUT, _vp, _LL, _vp], _int),
    "gpt_v0_score_respawn": ([_int, _int, _LAYOUT, _vp, _LL, ctypes.POINTER(_float), _vp],
                             _int),
    "gpt_v0_constants": ([ctypes.POINTER(_int)], _int),
}
CONTROL = cb.PlainKernel("v0_control", "env_v0.cu", FUNCTIONS, library="env_v0")
SCORE = cb.PlainKernel("v0_score_respawn", "env_v0.cu", FUNCTIONS, library="env_v0")


def refusal(logic) -> str | None:
    """Why the kernels do not take ``logic``'s world, or None."""
    cfg, lay = logic.cfg, logic.layout
    A, B = cfg.num_agents, lay.table.num_bodies
    if cfg.variant != "v0":
        return f"they take v0's env logic, got {cfg.variant}"
    if (A, B) not in WORLDS:
        return f"{A} agents and {B} bodies: they take (agents, bodies) in {WORLDS}"
    if lay.block_slot != BLOCK_SLOT or list(lay.agent_slots) != list(range(B - A, B)):
        return "the walls, the block and the agents are not in their slots"
    if len(lay.block_verts) > MAX_VERTS:
        return f"{len(lay.block_verts)} block vertices: they take at most {MAX_VERTS}"
    return None


def spawn_affine(logic) -> tuple[list, list]:
    """(lo, range) of ``V0Env._spawn_from``'s five maps ``lo + range * u`` (the
    block's x, y and angle, the agents' x, y), as float32 values rounded where
    ``common.scale`` rounds them: a Python float's ``hi - lo`` in float64 and
    then to float32 against the draws, a float32 array's in float32."""
    f32 = np.float32
    (bx_lo, bx_hi), (by_lo, by_hi), (ang_lo, ang_hi), (a_lo, a_hi) = logic.spawn_bounds()
    lo = [f32(bx_lo), f32(by_lo), f32(ang_lo), f32(a_lo), f32(a_lo)]
    rng = [f32(bx_hi - bx_lo), f32(by_hi - by_lo), f32(ang_hi - ang_lo),
           *(np.asarray(a_hi, f32) - f32(a_lo))]
    return [float(x) for x in lo], [float(x) for x in rng]


@functools.lru_cache(maxsize=None)
def layout(logic) -> Layout:
    """The kernels' view of ``logic``'s world (a V0Env).  Raises ValueError
    for a world they do not take (:func:`refusal`)."""
    from gym_puzzles_tpu_torch.envs import v0  # v0 imports this module

    why = refusal(logic)
    if why is not None:
        raise ValueError(f"the v0 env kernels: {why}")
    lay, table, f32 = logic.layout, logic.layout.table, np.float32
    L = Layout()
    L.P, L.n_verts, L.max_steps = table.num_pairs, len(lay.block_verts), logic.cfg.max_episode_steps
    consts = dict(scale=C.V0_SCALE, speed=C.V0_SPEED, two_pi=v0.TWO_PI, epsilon=C.V0_EPSILON,
                  ds=v0.DS, block_reward=C.V0_BLOCK_REWARD, final_reward=C.V0_FINAL_REWARD,
                  contact_reward=v0.CONTACT_REWARD, pow_base=v0.POW_BASE,
                  unit_floor=cm.UNIT_FLOOR)
    for name, value in consts.items():
        setattr(L, name, float(f32(value)))
    B = table.num_bodies
    L.lcx[:B] = [float(x) for x in table.local_center[:, 0]]
    L.lcy[:B] = [float(x) for x in table.local_center[:, 1]]
    walls = np.asarray(logic.wall_positions, f32)
    L.wall_x[:], L.wall_y[:] = [float(x) for x in walls[:, 0]], [float(x) for x in walls[:, 1]]
    verts = np.asarray(lay.block_verts, f32)
    n = len(verts)
    L.vert_x[:n], L.vert_y[:n] = [float(x) for x in verts[:, 0]], [float(x) for x in verts[:, 1]]
    L.goal[:] = [float(x) for x in np.asarray(logic.goal_px, f32)]
    L.lo[:], L.range[:] = spawn_affine(logic)
    return L


def _check(dev, planes):
    """Raise unless each (name, tensor, dtype, shape) lies on ``dev`` with
    that dtype and shape, contiguous (but the action, whose strides the
    kernel takes)."""
    for name, x, dtype, shape in planes:
        if (x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != dev
                or not (name == "action" or x.is_contiguous())):
            raise ValueError(f"{name}: expected contiguous {dtype} {list(shape)} on {dev}, "
                             f"got {x.dtype} {list(x.shape)} on {x.device}"
                             + ("" if x.is_contiguous() else ", not contiguous"))


def _launch(kernel, entry, dev, *args):
    """Call ``entry`` of ``kernel``'s library on the current stream of
    ``dev`` (a CUDA device, else ValueError), raise on a CUDA error or an
    uninstantiated world, count the launch.  The CPU tests put the host
    build's entries in its place."""
    if dev.type != "cuda":
        raise ValueError(f"the {kernel.name} kernel takes CUDA tensors, got {dev}")
    lib = kernel.load()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: error {err}")
    kernel.launches += 1


def _pointers(names, tensors: dict):
    return (_vp * len(names))(*(tensors[n].data_ptr() if n in tensors else None
                                for n in names))


def control(logic, state: cm.EnvState, action):
    """``V0Env._control_plain`` as one launch of the ``control`` kernel:
    ``action`` [act_dim, E] float32 (any strides) -> (Bodies with the agents'
    velocity and omega rows set, force [B, 2, E], torque [B, E], wake [B, E]
    bool), new tensors but the bodies' passed-through fields.  Raises
    ValueError for what the kernel does not take."""
    L = layout(logic)
    A, B = logic.cfg.num_agents, logic.layout.table.num_bodies
    bodies = state.bodies
    E = bodies.angle.shape[-1]
    dev = bodies.angle.device
    f32 = torch.float32
    _check(dev, (("action", action, f32, (3 * A, E)),
                 ("pos", bodies.pos, f32, (B, 2, E)), ("vel", bodies.vel, f32, (B, 2, E)),
                 ("omega", bodies.omega, f32, (B, E)),
                 ("agent_dist", state.agent_dist, f32, (A, E))))
    new = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
    out = dict(vel_out=new(B, 2, E), omega_out=new(B, E), force=new(B, 2, E), torque=new(B, E),
               wake=new(B, E, dtype=torch.bool))
    t = dict(out, action=action, pos=bodies.pos, vel=bodies.vel, omega=bodies.omega,
             agent_dist=state.agent_dist)
    dims = (ctypes.c_longlong * 3)(E, action.stride(0), action.stride(1))
    _launch(CONTROL, "gpt_v0_control", dev, A, B, ctypes.byref(L),
                     _pointers(CONTROL_PTRS, t), dims)
    return (bodies.replace(vel=out["vel_out"], omega=out["omega_out"]), out["force"],
            out["torque"], out["wake"])


def score_respawn(logic, state: cm.EnvState, bodies: Bodies, contacts: Contacts, goal_contact,
                  wall_contact, params, draws=None):
    """``PuzzleEnvLogic._finish`` as one launch of the ``score_respawn``
    kernel, from the pre-step ``state`` and the ticked world -> (state, obs
    [obs_dim, E], reward [E], done [E], info).  ``draws`` (``V0Env.
    _spawn_draws``' four uniforms, or None) respawn the envs that are done or
    truncated, as ``VectorEnv``'s fast autoreset would (module docstring).
    ``params`` fields may be Python floats or 0-d float32 tensors on the
    device (a graph's views, read there)."""
    L = layout(logic)
    cfg = logic.cfg
    A, B, P = cfg.num_agents, logic.layout.table.num_bodies, logic.layout.table.num_pairs
    E = bodies.angle.shape[-1]
    dev = bodies.angle.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    if draws is not None:
        # the respawned columns go into the ticked state's own tensors
        before = {x.untyped_storage().data_ptr() for x in cg.flatten(state)[0]}

        def own(x):
            if x.is_contiguous() and x.untyped_storage().data_ptr() not in before:
                return x
            return x.clone(memory_format=torch.contiguous_format)

        leaves, spec = cg.flatten((bodies, contacts, goal_contact, wall_contact))
        bodies, contacts, goal_contact, wall_contact = cg.unflatten(spec, map(own, leaves))
    man = contacts.man
    planes = [("pos", bodies.pos, f32, (B, 2, E)), ("angle", bodies.angle, f32, (B, E)),
              ("goal_contact", goal_contact, b8, (A, E)), ("goal", state.goal_pos, f32, (3, E)),
              ("prev_agent_dist", state.agent_dist, f32, (A, E)),
              ("prev_block_distance", state.block_distance, f32, (E,)),
              ("prev_blks", state.blks_in_place, i32, (E,)), ("prev_t", state.t, i32, (E,))]
    weights = (_float * len(WEIGHTS))()
    for i, name in enumerate(WEIGHTS):
        w = getattr(params, name)
        if isinstance(w, torch.Tensor):
            planes.append((name, w, f32, ()))
        else:
            weights[i] = float(w)
    new = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
    out = dict(obs=new(cfg.obs_dim, E), reward=new(E), done=new(E, dtype=b8),
               truncated=new(E, dtype=b8), info_t=new(E, dtype=i32),
               info_status=new(E, dtype=i32), agent_dist=new(A, E), block_distance=new(E),
               block_angle=new(E), blks=new(E, dtype=i32))
    counts = None
    if draws is not None:
        planes += [("u_bx", draws[0], f32, (E,)), ("u_by", draws[1], f32, (E,)),
                   ("u_ang", draws[2], f32, (E,)), ("u_axy", draws[3], f32, (A, 2, E)),
                   ("vel", bodies.vel, f32, (B, 2, E)), ("omega", bodies.omega, f32, (B, E)),
                   ("awake", bodies.awake, b8, (B, E)),
                   ("sleep_time", bodies.sleep_time, f32, (B, E)),
                   ("wall_contact", wall_contact, b8, (E,)), ("flip", man.flip, b8, (P, E)),
                   ("local_normal", man.local_normal, f32, (P, 2, E)),
                   ("local_point", man.local_point, f32, (P, 2, E)),
                   ("points", man.points, f32, (P, 2, 2, E)), ("ids", man.ids, i32, (P, 2, E)),
                   ("count", man.count, i32, (P, E)),
                   ("normal_impulse", contacts.normal_impulse, f32, (P, 2, E)),
                   ("tangent_impulse", contacts.tangent_impulse, f32, (P, 2, E)),
                   ("touching", contacts.touching, b8, (P, E))]
        out.update(t=new(E, dtype=i32), status=new(E, dtype=i32), goal_out=new(3, E))
        counts = profiling.respawn_counts(dev)
    _check(dev, planes)
    t = dict({name: x for name, x, _dtype, _shape in planes}, **out)
    if counts is not None:
        t["counts"] = counts
    _launch(SCORE, "gpt_v0_score_respawn", dev, A, B, ctypes.byref(L),
                     _pointers(SCORE_PTRS, t), (ctypes.c_longlong * 1)(E), weights)
    new_state = cm.EnvState(
        bodies=bodies, contacts=contacts, goal_contact=goal_contact, wall_contact=wall_contact,
        agent_dist=out["agent_dist"], block_distance=out["block_distance"],
        block_angle=out["block_angle"], blks_in_place=out["blks"],
        goal_pos=out.get("goal_out", state.goal_pos), t=out.get("t", out["info_t"]),
        done_status=out.get("status", out["info_status"]))
    info = {"done_status": out["info_status"], "truncated": out["truncated"], "t": out["info_t"]}
    return new_state, out["obs"], out["reward"], out["done"], info
