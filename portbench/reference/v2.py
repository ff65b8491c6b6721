"""MultiRobotPuzzle-v2 / MultiRobotPuzzleHeavy-v2 (a frozen copy of the
port's ``envs/v2.py``, on the reference's plain tick).

Car-like (non-holonomic) robots steered by (turn, vel) actions -- forward
force, lateral-velocity-killing impulse, the spin-pumping
ApplyAngularImpulse(+0.1*I*w) quirk, and the inverted torque sign
(02.py:444-474, SURVEY quirk #8) -- pushing a low-friction T-block to a
random goal in the right third of the screen.  Normalized observations with
the scaled-epsilon tail; out-of-bounds termination with shaped penalties;
completion reward scaled by the fraction of agents in contact.

Departures from the published ``multi_robot_puzzle_02.py``: none beyond the
port's quirk ledger (SURVEY): the spin pump and the inverted torque sign
kept as published, the Chebyshev unit vector of the soft assist, the goal
border's local shadow (0.4 under SIMPLE), and the fast autoreset's spawn
without the reset's random step.  What is added is :meth:`V2Env.spawn_bad`,
the benchmark's test of a fresh spawn.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import common as cm
from portbench.reference import config as C
from portbench.reference import world as eng
from portbench.reference.base import PuzzleEnvLogic
from portbench.reference.types import device_const

RATIO = float(np.float32(C.V2_RATIO))  # SCALE/VIEWPORT_W = m -> screen-width fraction
TWO_PI = 2.0 * math.pi
MAX_TORQUE = 0.0005
SPAWN_SLACK = 1e-4  # m (or normalized units): float32 rounding of a spawn's poses


def norm_angle(a):
    """02.py:255-261: angle -> [-1, 1] with a sign flip at pi."""
    theta = torch.remainder(a, TWO_PI)
    return torch.where(theta <= math.pi, -theta / math.pi, (TWO_PI - theta) / math.pi)


class V2Env(PuzzleEnvLogic):
    # -- spawn (02.py:303-361; SIMPLE/ANYWHERE branches selected by the
    # cfg's v2_simple/v2_anywhere -- the registered envs run the module
    # constants SIMPLE=True/ANYWHERE=False, 02.py:61-62) -------------------
    def _spawn(self, gen, num_envs):
        lay = self.layout
        A, E = self.cfg.num_agents, num_envs
        dev = gen.device
        simple, anywhere = self.cfg.v2_simple, self.cfg.v2_anywhere
        w, h = lay.world_w, lay.world_h
        b = C.V2_BORDER

        def pair(x, y):
            return device_const(np.array([x, y], np.float32), dev)[:, None]

        bang = cm.uniform(gen, 0.0, 2.0 * np.pi, (E,))
        if simple:
            # block centered (02.py:316-317)
            bxy = pair(w / 2.0, h / 2.0).expand(2, E)
        else:
            # block uniform in the middle third (02.py:318-320)
            bxy = cm.uniform(gen, pair(w / 3.0 + b, b), pair(w * 2.0 / 3.0 - b, h - b), (2, E))

        # agents: left third (ANYWHERE=False) or full width (02.py:349-355)
        ax_hi = (w - b) if anywhere else (w / 3.0 - b)
        axy = cm.uniform(gen, b, pair(ax_hi, h - b), (A, 2, E))
        if simple:
            a_ang = torch.full((A, E), 1.5 * np.pi, dtype=torch.float32, device=dev)  # 02.py:356
        else:
            a_ang = cm.uniform(gen, 0.0, 2.0 * np.pi, (A, E))  # 02.py:357

        walls = device_const(np.asarray(self.wall_positions, np.float32), dev)
        origin = torch.cat([walls[..., None].expand(4, 2, E), bxy[None], axy])
        angles = torch.cat([torch.zeros((4, E), device=dev), bang[None], a_ang])
        bodies = eng.init_bodies(lay.table, origin, angles)

        # random goal in the right third, stored normalized (02.py:303-311;
        # the goal border is 0.4 under SIMPLE, 0.3 otherwise -- a local
        # shadow of the module BORDER, 02.py:305-306)
        gb = 0.4 if simple else 0.3
        gx = cm.uniform(gen, w * 2.0 / 3.0 + gb, w - gb, (E,)) * RATIO
        gy = cm.uniform(gen, gb, h - gb, (E,)) * RATIO
        goal = torch.stack([gx, gy, torch.zeros_like(gx)])
        return bodies, goal

    # -- distances in normalized units (02.py:263-277) ----------------------
    def _distances(self, bodies, goal_pos):
        lay = self.layout
        bc, ac = cm.centers(lay, bodies)
        block_distance = cm.distance(bc * RATIO, goal_pos[:2])
        agent_dist = cm.distance(ac * RATIO, bc[None] * RATIO)
        block_angle = torch.abs(
            torch.remainder(goal_pos[2], TWO_PI)
            - torch.remainder(torch.abs(bodies.angle[lay.block_slot]), TWO_PI)
        )
        return agent_dist, block_distance, block_angle

    # -- control (02.py:446-474) --------------------------------------------
    def _control(self, state, action):
        lay = self.layout
        A = self.cfg.num_agents
        E = action.shape[-1]
        dev = action.device
        a = action.reshape(A, 2, E)
        turn, vel_cmd = a[:, 0], a[:, 1]

        bodies = state.bodies
        slots = lay.agent_slots  # numpy, for static table lookups only
        a0 = int(slots[0])
        sl = slice(a0, a0 + A)
        c, s = torch.cos(bodies.angle[sl]), torch.sin(bodies.angle[sl])  # [A, E]

        # forward force f = R*(0,1)*vel*FORCE applied at R*(0,2) offset from
        # the COM -- parallel to the offset, so zero torque (02.py:449-454)
        fwd = torch.stack([-s, c], dim=1)  # R*(0,1)
        f_agent = fwd * (vel_cmd * C.V2_FORCE)[:, None]

        # lateral friction impulse: v -= dot(right, v) * right
        # (ApplyLinearImpulse at the COM changes v immediately, 02.py:116-122)
        right = torch.stack([c, s], dim=1)  # R*(1,0)
        v_a = bodies.vel[sl]
        lat = (right[:, 0] * v_a[:, 0] + right[:, 1] * v_a[:, 1])[:, None] * right
        v_a = v_a - lat

        # ApplyAngularImpulse(0.1 * inertia * w): w += invI * 0.1 * I_origin * w.
        # v2 agents have localCenter=(0,0) so this is w *= 1.1 -- it PUMPS
        # spin (02.py:456, quirk #8 part 1)
        w_a = bodies.omega[sl]
        table = lay.table
        i_origin = table.inertia_com[slots] + table.mass[slots] * (
            table.local_center[slots] ** 2
        ).sum(-1)
        pump = device_const(np.asarray(0.1 * i_origin, np.float32), dev)[:, None]
        inv_i = device_const(np.asarray(table.inv_inertia[slots], np.float32), dev)[:, None]
        w_a = w_a + inv_i * (pump * w_a)

        # torque: magnitude from |turn|, sign INVERTED, zeroed if |vel|<0.1
        # (02.py:458-467, quirk #8 part 2)
        torque_mag = torch.abs(turn) * MAX_TORQUE
        turn_eff = torch.where(torch.abs(vel_cmd) < 0.1, 0.0, turn)
        t_agent = torch.where(turn_eff < 0.0, torque_mag,
                              torch.where(turn_eff > 0.0, -torque_mag, 0.0))

        # soft assist on the block: 10^(-dist)/50 along Chebyshev direction
        bc, ac = cm.centers(lay, bodies)
        mag = torch.pow(10.0, -state.agent_dist) / 50.0
        unit = cm.chebyshev_unit(ac, bc[None])
        block_force = (mag[:, None] * unit).sum(dim=0)

        force = cm.body_rows(lay, block_force, f_agent)
        torque = cm.body_rows(lay, torch.zeros((E,), dtype=torch.float32, device=dev), t_agent)
        vel = cm.set_agent_rows(lay, bodies.vel, v_a)
        omega = cm.set_agent_rows(lay, bodies.omega, w_a)

        # every agent gets ApplyForce/Impulse with wake=True; block likewise
        wake = torch.cat([torch.zeros((4, E), dtype=torch.bool, device=dev),
                          torch.ones((1 + A, E), dtype=torch.bool, device=dev)])
        return bodies.replace(vel=vel, omega=omega), force, torque, wake

    # -- obs + reward + done (02.py:488-584) --------------------------------
    def _score(self, state, bodies, goal_contact, agent_dist, block_distance,
               block_angle, params):
        lay = self.layout
        A = self.cfg.num_agents
        bc, ac = cm.centers(lay, bodies)
        E = bc.shape[-1]
        a0 = int(lay.agent_slots[0])
        sl = slice(a0, a0 + A)

        a_xy = ac * RATIO
        b_xy = bc * RATIO
        agent_obs = torch.cat(
            [
                a_xy,
                norm_angle(bodies.angle[sl])[:, None],
                a_xy - b_xy[None],
                bodies.vel[sl],
                bodies.omega[sl][:, None],
                agent_dist[:, None],
            ],
            dim=1,
        ).reshape(-1, E)

        x, y = b_xy[0], b_xy[1]
        angle = torch.remainder(bodies.angle[lay.block_slot], TWO_PI)
        fx, fy, fangle = state.goal_pos[0], state.goal_pos[1], state.goal_pos[2]
        a_diff = (torch.remainder(fangle, TWO_PI) - angle) / math.pi
        blk_obs = torch.stack([x - fx, y - fy, a_diff, cm.distance(b_xy, state.goal_pos[:2])])

        verts = cm.block_world_vertices(lay, bodies) * RATIO
        # ones * eps: ``scaled_epsilon`` may be a 0-d tensor
        eps = torch.ones((1, E), dtype=torch.float32, device=bc.device) * params.scaled_epsilon
        obs = torch.cat([agent_obs, blk_obs, verts.reshape(-1, E), eps])

        # shaping (02.py:537-546): no /4 factors, no contact bonus
        reward = (state.block_distance - block_distance) * params.weight_delta_block
        reward = reward - params.weight_blk_dist * block_distance
        delta_agent = state.agent_dist - agent_dist
        reward = reward + (delta_agent * params.weight_delta_agent).sum(dim=0)
        reward = reward - (params.weight_agent_dist * agent_dist).sum(dim=0)

        # out-of-bounds checks on world-unit centers (02.py:279-295)
        w, h = lay.world_w, lay.world_h
        bnd = C.V2_BOUNDS

        def oob(c):  # [..., 2, E]
            cx, cy = c[..., 0, :], c[..., 1, :]
            return (cx < bnd) | (cx > w - bnd) | (cy < bnd) | (cy > h - bnd)

        agent_oob = oob(ac).any(dim=0)
        block_oob = oob(bc)

        in_place = (torch.abs(fx - x) <= params.scaled_epsilon) & (
            torch.abs(fy - y) <= params.scaled_epsilon
        )
        blks_new = in_place.to(torch.int32)
        n_contact = goal_contact.sum(dim=0, dtype=torch.int32)
        complete = blks_new == 1

        # priority: agent OOB > block OOB > completion (early returns in the
        # reference; blks_in_place only updates on the completion path)
        bonus = params.shaped_puzzle_reward * (n_contact.to(torch.float32) / A)
        reward = torch.where(
            agent_oob,
            reward - params.shaped_bounds_penalty,
            torch.where(
                block_oob,
                reward - params.shaped_blk_bounds_penalty,
                reward + torch.where(complete, bonus, 0.0),
            ),
        )
        done = agent_oob | block_oob | complete
        done_status = torch.where(
            agent_oob, 1, torch.where(block_oob, 2, torch.where(complete, 3, 0))
        ).to(torch.int32)
        blks = torch.where(agent_oob | block_oob, state.blks_in_place, blks_new)
        return obs, reward.to(torch.float32), done, done_status, blks

    # -- what a fresh spawn is -------------------------------------------------
    def spawn_bad(self, s) -> torch.Tensor:
        """[E] bool: a state that is no fresh spawn of :meth:`_spawn`'s box:
        the block's origin (centred under SIMPLE, else in the middle third),
        the agents' origins (the left third unless ANYWHERE) and angles
        (1.5 pi under SIMPLE), the goal (the right third, angle 0), or the
        clock, velocities, contacts or awake flags of a state that has
        stepped."""
        lay, cfg = self.layout, self.cfg
        w, h, b, d = lay.world_w, lay.world_h, C.V2_BORDER, SPAWN_SLACK
        A = cfg.num_agents
        origin, _q = eng.body_origins(lay.table, s.bodies)
        blk = origin[lay.block_slot]  # [2, E]
        a0 = int(lay.agent_slots[0])
        agents = origin[a0:a0 + A]  # [A, 2, E]

        def outside(p, x_lo, x_hi, y_lo, y_hi):  # [..., 2, E] -> [..., E]
            x, y = p[..., 0, :], p[..., 1, :]
            return (x < x_lo - d) | (x > x_hi + d) | (y < y_lo - d) | (y > y_hi + d)

        if cfg.v2_simple:
            out = outside(blk, w / 2.0, w / 2.0, h / 2.0, h / 2.0)
            out |= ((s.bodies.angle[a0:a0 + A] - float(np.float32(1.5 * np.pi))).abs()
                    > d).any(0)
        else:
            out = outside(blk, w / 3.0 + b, w * 2.0 / 3.0 - b, b, h - b)
        out |= outside(agents, b, (w - b) if cfg.v2_anywhere else (w / 3.0 - b), b,
                       h - b).any(0)
        gb = 0.4 if cfg.v2_simple else 0.3
        goal = s.goal_pos[:2] / RATIO
        out |= outside(goal, w * 2.0 / 3.0 + gb, w - gb, gb, h - gb) | (s.goal_pos[2] != 0)
        out |= s.t != 0
        out |= (s.bodies.vel != 0).any(dim=(0, 1)) | (s.bodies.omega != 0).any(0)
        out |= s.contacts.touching.any(0) | ~s.bodies.awake.all(0)
        return out


# the logic that ``portbench.check.RefEnv`` finds by the variant's name
Env = V2Env
