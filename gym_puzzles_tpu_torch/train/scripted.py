"""Scripted controllers over the public observation layout (port of
``gym_puzzles_tpu/train/scripted.py``).

``pusher_action`` is a hand-coded herd-and-push controller for the
v0-family holonomic envs (obs layout multi_robot_puzzle_00.py:442-472):
every agent approaches a staging point a fixed offset behind the block
(opposite the goal), then leans through the block toward the goal at max
speed.  ``planner_action`` is its successor: it reconstructs the block's
world geometry from the vertex section of the obs (00.py:470-472), slots
agents along the actual back face (sorted assignment, no path crossing),
routes around the block, and gates the push until the formation is in
place.  Both are elementwise torch ops on ``[E, obs_dim]`` obs, on whatever
device the obs live.  Used two ways:

* as a physical-ceiling probe for the registered reward bars,
* as the demonstrator for imitation bootstrap (``train/imitate.py``).
"""

from __future__ import annotations

import math

import torch


def _norm(x, keepdim=False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def pusher_action(obs, num_agents: int, offset_px: float = 70.0, push_px: float = 30.0):
    """[E, obs_dim] v0-family obs -> [E, 3*num_agents] actions in [-1, 1].

    Two-phase potential controller: approach the staging point
    ``block - g_hat * offset_px`` (g_hat = unit block->goal), and once the
    agent sits behind the block (cos > 0.6 against its slot direction),
    drive through the block toward the goal (``block + g_hat * push_px``).
    Velocities are unit-infinity normalized: full speed on the dominant axis
    (the env scales actions by MAX_SPEED, 00.py:419-420).
    """
    E = obs.shape[0]
    ag = obs[:, : 4 * num_agents].reshape(E, num_agents, 4)
    a2b = -ag[:, :, 0:2]  # agent->block, px (obs stores agent-block)
    blk = obs[:, 4 * num_agents: 4 * num_agents + 4]
    b2g = -blk[:, 0:2]  # block->goal, px (obs stores block-goal)
    g_hat = b2g / _norm(b2g, keepdim=True).clamp_min(1e-6)
    rel_a = -a2b  # block->agent
    dist_a = _norm(rel_a, keepdim=True).clamp_min(1e-6)
    rel_n = rel_a / dist_a
    # per-agent slot directions fanned around -g_hat: five agents cannot
    # share one staging point (they jam each other and never move the
    # block); each gets its own contact slot behind the block.
    num = a2b.shape[1]
    theta = (torch.linspace(-0.6, 0.6, num, dtype=obs.dtype, device=obs.device) if num > 1
             else torch.zeros((1,), dtype=obs.dtype, device=obs.device))
    c, s = torch.cos(theta), torch.sin(theta)
    gx, gy = -g_hat[:, 0], -g_hat[:, 1]  # [E]
    u = torch.stack([gx[:, None] * c[None] - gy[:, None] * s[None],
                     gx[:, None] * s[None] + gy[:, None] * c[None]], dim=-1)
    behindness = (rel_n * u).sum(-1)  # 1 = at own slot direction
    slot_target = a2b + u * offset_px  # agent -> its staging slot
    # orbit while not behind: chasing the slot in a straight line ploughs
    # through the block (and a pushed block flees the pursuing agents).
    # Circle the block at a safe radius instead: tangential drive + radial
    # correction onto the orbit, signed toward the shorter way to the slot.
    orbit_r = offset_px
    tang = torch.stack([-rel_n[..., 1], rel_n[..., 0]], dim=-1)
    sign = torch.sign((tang * slot_target).sum(-1, keepdim=True) + 1e-6)
    orbit = (sign * tang * 120.0
             + rel_n * (orbit_r - dist_a))  # radial: settle onto the circle
    near = dist_a[..., 0] < orbit_r + 60.0
    approach = torch.where((near & (behindness < 0.6))[:, :, None], orbit, slot_target)
    # once slotted: push straight toward the goal at full speed -- all
    # agents' forces aligned, maximum momentum transfer into the block.
    in_slot = (behindness > 0.6) & (dist_a[..., 0] < orbit_r + 60.0)
    push = g_hat[:, None, :] * max(push_px, 1.0)
    des = torch.where(in_slot[:, :, None], push, approach)
    mag = des.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    v = des / mag
    act = torch.cat([v, v.new_zeros((E, num_agents, 1))], dim=-1)
    return act.reshape(E, 3 * num_agents)


def planner_action(obs, num_agents: int, gate: int | None = None, slot_gap_px: float = 24.0,
                   tol_px: float = 35.0):
    """[E, obs_dim] v0-family obs -> [E, 3*num_agents] actions in [-1, 1].

    Geometry-aware gated herd-and-push (see the module docstring).  Phases,
    all computed statelessly from the current obs:

    1. Reconstruct world geometry: block center = goal + (block-goal) obs,
       block outline = the 8 world-space vertex obs (00.py:455-472).
    2. Find the back face: vertices at the support extreme along -u
       (u = unit block->goal); slot ``num_agents`` staging points evenly
       across that face's tangential span, ``slot_gap_px`` off the face.
    3. Sorted assignment: agents ranked by tangential coordinate take
       slots in the same order -- approach paths never cross.
    4. Routing: far agents drive straight at their slot; agents near the
       block but not behind it orbit around (tangential + radial
       correction), signed toward their slot.
    5. Gate: until >= ``gate`` agents (default ``max(num_agents - 2, 1)``)
       sit within ``tol_px`` of their slots, arrived agents station-keep
       instead of pushing.  Once open, arrived agents drive through the
       block toward the goal at full speed.
    """
    E = obs.shape[0]
    A = num_agents
    if gate is None:
        gate = max(A - 2, 1)
    ag = obs[:, : 4 * A].reshape(E, A, 4)
    rel = ag[:, :, 0:2]  # agent - block_center, px
    blk = obs[:, 4 * A: 4 * A + 4]
    b2g = -blk[:, 0:2]  # block -> goal, px
    gl2 = _norm(b2g, keepdim=True).clamp_min(1e-6)
    u = b2g / gl2  # [E, 2] push direction
    perp = torch.stack([-u[:, 1], u[:, 0]], dim=-1)  # [E, 2]
    verts = obs[:, 4 * A + 4: 4 * A + 4 + 16].reshape(E, 8, 2)
    # verts are world px; block center world = goal + blk[0:2]; goal is the
    # fixed (320, 262.5) of the v0 family (00.py:115-128)
    bc = torch.tensor([320.0, 262.5], dtype=obs.dtype, device=obs.device)[None] + blk[:, 0:2]
    vrel = verts - bc[:, None]  # [E, 8, 2] block-centered outline

    s_v = (vrel * -u[:, None]).sum(-1)  # support coords along -u
    smax = s_v.amax(dim=-1, keepdim=True)
    # slot tangential offsets at the agents' physical packing pitch (the
    # octagons are 1.5 m = 45 px wide; the heavy T's bar face is 6 m =
    # 180 px, exactly five slots), centered on the push line.
    offs = ((torch.arange(A, dtype=obs.dtype, device=obs.device) - (A - 1) / 2.0)
            * 46.0).expand(E, A)  # [E, A] sorted ascending
    slot_s = smax + slot_gap_px  # [E, 1]
    slots = (-u[:, None] * slot_s[..., None]
             + perp[:, None] * offs[..., None])  # [E, A, 2] block-centered

    # sorted assignment: agent tangential rank -> slot rank
    p_a = (rel * perp[:, None]).sum(-1)  # [E, A]
    rank = torch.argsort(torch.argsort(p_a, dim=-1, stable=True), dim=-1, stable=True)
    my_slot = torch.gather(slots, 1, rank[..., None].expand(E, A, 2))  # [E, A, 2]

    to_slot = my_slot - rel  # [E, A, 2]
    d_slot = _norm(to_slot)  # [E, A]
    arrived = d_slot < tol_px
    # veto the push while a straggler is in the frontal sector: the block
    # would be shoved straight into it, stalling both
    front_dist = _norm(rel)
    blocking = ((rel * u[:, None]).sum(-1) > 0.0) & (front_dist < 175.0)
    gate_open = ((arrived.sum(-1, keepdim=True) >= gate)
                 & ~blocking.any(dim=-1, keepdim=True))  # [E, 1]

    # routing: tangent-point avoidance around the block's inflated
    # bounding circle.  If the straight segment to the slot crosses the
    # circle, head for the tangent touch point on the angular side of the
    # slot; if inside the circle, spiral out-and-around.
    dist_b = _norm(rel).clamp_min(1e-6)  # [E, A]
    r_blk = _norm(vrel).amax(dim=-1, keepdim=True)  # [E, 1]
    d_m = _norm(my_slot)  # slot distance from center
    r_c = torch.clamp_min(torch.minimum(r_blk + 8.0, d_m - 10.0), 20.0)  # [E, A]
    phi_q = torch.atan2(rel[..., 1], rel[..., 0])
    phi_m = torch.atan2(my_slot[..., 1], my_slot[..., 0])
    dphi = torch.remainder(phi_m - phi_q + math.pi, 2.0 * math.pi) - math.pi
    side = torch.where(dphi >= 0.0, 1.0, -1.0)
    # antipodal agents (slot on the far side) have an unstable dphi sign:
    # tiebreak by slot rank, lower-ranked agents round on the - side.
    stable = torch.where(rank > (A - 1) / 2.0, 1.0, -1.0)
    side = torch.where(dphi.abs() > math.pi - 0.4, stable, side)
    # does the straight segment agent->slot cross the routing circle?
    t_seg = torch.clamp(((-rel) * to_slot).sum(-1)
                        / (to_slot ** 2).sum(-1).clamp_min(1e-6), 0.0, 1.0)
    closest = rel + t_seg[..., None] * to_slot
    crosses = _norm(closest) < r_c - 1.0
    outside = dist_b > r_c + 2.0
    beta = torch.arccos(torch.clamp(r_c / dist_b, -1.0, 1.0))
    phi_t = phi_q + side * beta
    touch = r_c[..., None] * torch.stack([torch.cos(phi_t), torch.sin(phi_t)], dim=-1)
    to_tangent = touch - rel
    rn = rel / dist_b[..., None]
    tang = torch.stack([-rn[..., 1], rn[..., 0]], dim=-1)
    escape = (rn * (r_c + 12.0 - dist_b)[..., None] * 3.0
              + side[..., None] * tang * 120.0)
    des = torch.where((crosses & outside)[..., None], to_tangent,
                      torch.where((crosses & ~outside)[..., None], escape, to_slot))

    # push / station-keep
    push = u[:, None].expand(des.shape) * 100.0
    hold = to_slot * 0.05  # proportional station-keeping, sub-max speed
    des = torch.where((arrived & gate_open)[..., None], push,
                      torch.where((arrived & ~gate_open)[..., None], hold, des))

    mag = des.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    scale = torch.where(des.abs().amax(dim=-1, keepdim=True) > 40.0, 1.0 / mag, 1.0 / 40.0)
    v = torch.clamp(des * scale, -1.0, 1.0)
    act = torch.cat([v, v.new_zeros((E, A, 1))], dim=-1)
    return act.reshape(E, 3 * A)
