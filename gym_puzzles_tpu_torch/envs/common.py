"""Shared env-layer machinery: state dataclass, engine plumbing, helpers.

Port of ``gym_puzzles_tpu/envs/common.py``.  The JAX package writes the env
logic for one env and vmaps it; here every function is written for the whole
batch, env axis last on every state tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_puzzles_tpu_torch.engine import step_cuda
from gym_puzzles_tpu_torch.engine import world as eng
from gym_puzzles_tpu_torch.engine.types import Bodies, Contacts, Replaceable, device_const
from gym_puzzles_tpu_torch.envs.layout import WorldLayout


@dataclasses.dataclass
class EnvState(Replaceable):
    """Everything the reference keeps on ``self`` that affects behavior."""

    bodies: Bodies
    contacts: Contacts
    goal_contact: torch.Tensor  # [A, E] bool (ContactDetector flags, 00.py:92-111)
    wall_contact: torch.Tensor  # [E] bool (set but never consumed by the reference)
    agent_dist: torch.Tensor  # [A, E] f32 (units are variant-specific)
    block_distance: torch.Tensor  # [E] f32
    block_angle: torch.Tensor  # [E] f32
    blks_in_place: torch.Tensor  # [E] int32
    goal_pos: torch.Tensor  # [3, E] f32 (fx, fy, fangle) in variant units
    t: torch.Tensor  # [E] int32 steps since reset
    done_status: torch.Tensor  # [E] int32: 0 running, 1 agent-oob, 2 block-oob, 3 complete


def select(mask, a, b):
    """Per-env select between two state trees (dataclasses of tensors);
    ``mask`` [E] broadcasts on the trailing env axis."""
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: select(mask, getattr(a, f.name), getattr(b, f.name))
                          for f in dataclasses.fields(a)})
    return torch.where(mask, a, b)


def distance(a, b):
    """Euclidean distance over axis -2 of [..., 2, E] tensors (00.py:130-132)."""
    d = a - b
    return torch.sqrt(d[..., 0, :] * d[..., 0, :] + d[..., 1, :] * d[..., 1, :])


UNIT_FLOOR = 1e-12  # chebyshev_unit's floor on its divisor


def chebyshev_unit(src, dst):
    """The reference's ``unitVector`` (00.py:134-138): difference normalized
    by the max-abs component (Chebyshev norm), biasing diagonals.  The floor
    guards the prob-0 coincident-centers division.  [..., 2, E]."""
    d = dst - src
    denom = torch.maximum(torch.abs(d[..., 0, :]), torch.abs(d[..., 1, :]))
    return d / torch.clamp_min(denom, UNIT_FLOOR)[..., None, :]


def update_contact_flags(layout: WorldLayout, info: eng.StepInfo, goal_contact, wall_contact):
    """Fold one tick's begin/end touch events into the ContactDetector flags.
    When both a begin and an end hit the same flag in one tick, *end wins*
    (the older contact's end event lands last in Box2D's contact list)."""
    dev = goal_contact.device
    ab = device_const(layout.agent_block_pairs, dev)[..., None]  # [A, P, 1]
    begin = (ab & info.begin[None]).any(dim=1)
    end = (ab & info.end[None]).any(dim=1)
    goal_contact = torch.where(end, False, torch.where(begin, True, goal_contact))

    aw = device_const(layout.agent_wall_pairs, dev)[..., None]
    w_begin = (aw & info.begin[None]).any(dim=1).any(dim=0)
    w_end = (aw & info.end[None]).any(dim=1).any(dim=0)
    wall_contact = torch.where(w_end, False, torch.where(w_begin, True, wall_contact))
    return goal_contact, wall_contact


def physics(layout: WorldLayout, cfg, bodies: Bodies, contacts: Contacts,
            force, torque, wake, goal_contact, wall_contact, tick=eng.step):
    """Run ``frameskip`` engine ticks with ``tick``.  Forces and control wakes
    apply to the first tick only: Box2D clears accumulators after every Step,
    and the reference applies controls once before its frameskip loop
    (00.py:413-428)."""
    bodies, contacts, info = tick(
        layout.table, bodies, contacts, force, torque, wake,
        cfg.dt, cfg.velocity_iters, cfg.position_iters,
    )
    goal_contact, wall_contact = update_contact_flags(layout, info, goal_contact, wall_contact)
    for _ in range(cfg.frameskip - 1):
        bodies, contacts, info = tick(
            layout.table, bodies, contacts,
            torch.zeros_like(force), torch.zeros_like(torque), torch.zeros_like(wake),
            cfg.dt, cfg.velocity_iters, cfg.position_iters,
        )
        goal_contact, wall_contact = update_contact_flags(
            layout, info, goal_contact, wall_contact
        )
    return bodies, contacts, goal_contact, wall_contact


def physics_fused(layout: WorldLayout, cfg, bodies, contacts,
                  force, torque, wake, goal_contact, wall_contact):
    """:func:`physics` with each engine tick in the fused CUDA kernel
    (``engine/step_cuda.py``); on CPU tensors that entry point runs the
    plain ``world.step``."""
    return physics(layout, cfg, bodies, contacts, force, torque, wake,
                   goal_contact, wall_contact, tick=step_cuda.step_fused)


def physics_batched(layout: WorldLayout, cfg, bodies, contacts,
                    force, torque, wake, goal_contact, wall_contact):
    """:func:`physics` with each engine tick staged: PyTorch ops around the
    CUDA contact-solve kernel (``world.step_batched``); on CPU tensors that
    entry point runs the plain solve."""
    return physics(layout, cfg, bodies, contacts, force, torque, wake,
                   goal_contact, wall_contact, tick=eng.step_batched)


def block_world_vertices(layout: WorldLayout, bodies: Bodies):
    """World positions of the dedup'd block vertices [8, 2, E]."""
    origin, q = eng.body_origins(layout.table, bodies)
    b = layout.block_slot
    verts = device_const(np.asarray(layout.block_verts, np.float32),
                         origin.device)[..., None]  # [8, 2, 1]
    c, s = q[b, 0], q[b, 1]
    vx, vy = verts[:, 0], verts[:, 1]
    return torch.stack([(c * vx - s * vy) + origin[b, 0],
                        (s * vx + c * vy) + origin[b, 1]], dim=1)


def centers(layout: WorldLayout, bodies: Bodies):
    """(block_center [2, E], agent_centers [A, 2, E]) world COM; agents
    occupy the contiguous trailing slots."""
    a0 = int(layout.agent_slots[0])
    return bodies.pos[layout.block_slot], bodies.pos[a0:a0 + layout.num_agents]


def set_agent_rows(layout: WorldLayout, full, agent_rows):
    """Replace the agent rows of a [B, ...] tensor."""
    a0 = int(layout.agent_slots[0])
    return torch.cat([full[:a0], agent_rows], dim=0)


def body_rows(layout: WorldLayout, block_row, agent_rows):
    """Assemble a per-body tensor: zeros for walls, given block row, given
    agent rows.  Shapes: block_row [..., E], agent_rows [A, ..., E]."""
    zeros = torch.zeros((layout.block_slot,) + tuple(block_row.shape),
                        dtype=block_row.dtype, device=block_row.device)
    return torch.cat([zeros, block_row[None], agent_rows], dim=0)


def uniform(gen: torch.Generator, lo, hi, shape):
    """Uniform floats in [lo, hi) drawn from ``gen`` on its device."""
    return scale(draw(gen, shape), lo, hi)


def draw(gen: torch.Generator, shape):
    """Uniform float32 in [0, 1) drawn from ``gen`` on its device."""
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)


def scale(u, lo, hi):
    """Draws ``u`` in [0, 1) moved to [lo, hi): ``lo + (hi - lo) * u``."""
    return lo + (hi - lo) * u
