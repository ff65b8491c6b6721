"""MultiRobotPuzzle-v0 / MultiRobotPuzzleHeavy-v0 (port of
``gym_puzzles_tpu/envs/v0.py``).

Holonomic (velocity-set) octagon robots push a T-block to a fixed goal at
screen center + (0, 0.75 m); unnormalized pixel-scale observations; reward
shaped by delta-distances, proximity penalties, per-agent contact bonus, the
+-10 block-in-place reward and +10000 completion (00.py:474-519).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import world as eng
from portbench.reference.types import device_const
from portbench.reference import common as cm
from portbench.reference import config as C
from portbench.reference.base import PuzzleEnvLogic

DS = 1.0  # downsample factor (00.py:38); kept explicit in the reward math
TWO_PI = 2.0 * math.pi


class V0Env(PuzzleEnvLogic):
    def __init__(self, cfg):
        super().__init__(cfg)
        # set_final_loc (00.py:115-128): goal at screen center + rel*SCALE px.
        w, h = C.V0_VIEWPORT_W, C.V0_VIEWPORT_H
        self.goal_px = np.array(
            [w // 2 + 0.0 * C.V0_SCALE, h // 2 + 0.75 * C.V0_SCALE, 0.0], np.float32
        )  # (320, 262.5, 0)

    # -- spawn (00.py:299-378): block first, then agents; all uniform in the
    # bordered screen box ---------------------------------------------------
    def _spawn(self, gen, num_envs):
        lay = self.layout
        A, E = self.cfg.num_agents, num_envs
        dev = gen.device
        w, h = lay.world_w, lay.world_h
        b = C.V0_BORDER

        bx = cm.uniform(gen, b, w - b, (E,))
        by = cm.uniform(gen, b, h - b, (E,))
        bang = cm.uniform(gen, 0.0, 2.0 * np.pi, (E,))
        hi = device_const(np.array([w - b, h - b], np.float32), dev)[:, None]
        axy = cm.uniform(gen, b, hi, (A, 2, E))

        walls = device_const(np.asarray(self.wall_positions, np.float32), dev)
        origin = torch.cat([
            walls[..., None].expand(4, 2, E),
            torch.stack([bx, by])[None],
            axy,
        ])
        angles = torch.cat([torch.zeros((4, E), device=dev), bang[None],
                            torch.zeros((A, E), device=dev)])
        bodies = eng.init_bodies(lay.table, origin, angles)
        goal = device_const(self.goal_px, dev)[:, None].expand(3, E).clone()
        return bodies, goal

    # -- distances in pixel units (00.py:277-291) ---------------------------
    def _distances(self, bodies, goal_pos):
        s = C.V0_SCALE
        bc, ac = cm.centers(self.layout, bodies)
        block_distance = cm.distance(bc * s, goal_pos[:2])
        fangle = goal_pos[2]
        angle = bodies.angle[self.layout.block_slot]
        block_angle = torch.abs(
            torch.remainder(fangle, TWO_PI) - torch.remainder(torch.abs(angle), TWO_PI)
        )
        agent_dist = cm.distance(ac * s, bc[None] * s)
        return agent_dist, block_distance, block_angle

    # -- control (00.py:415-424): velocity set + soft assist ----------------
    def _control(self, state, action):
        lay = self.layout
        A = self.cfg.num_agents
        E = action.shape[-1]
        a = action.reshape(A, 3, E)
        vel_set = a[:, :2] * C.V0_SPEED
        omega_set = a[:, 2]

        bodies = state.bodies
        vel = cm.set_agent_rows(lay, bodies.vel, vel_set)
        omega = cm.set_agent_rows(lay, bodies.omega, omega_set)

        # soft force: per agent, 1.1^(-agent_dist) along the Chebyshev unit
        # vector agent->block, accumulated on the block (quirks #3, #9)
        bc, ac = cm.centers(lay, bodies)
        mag = torch.pow(1.1, -state.agent_dist)  # [A, E]
        unit = cm.chebyshev_unit(ac, bc[None])  # [A, 2, E]
        block_force = (mag[:, None] * unit).sum(dim=0)

        force = cm.body_rows(lay, block_force, torch.zeros_like(vel_set))
        torque = torch.zeros_like(bodies.omega)

        # wakes: SetLinearVelocity/SetAngularVelocity wake on nonzero value;
        # ApplyForce(wake=True) always wakes the block.
        agent_wake = (vel_set[:, 0] * vel_set[:, 0] + vel_set[:, 1] * vel_set[:, 1]) > 0.0
        agent_wake = agent_wake | (omega_set * omega_set > 0.0)
        dev = action.device
        wake = torch.cat([torch.zeros((4, E), dtype=torch.bool, device=dev),
                          torch.ones((1, E), dtype=torch.bool, device=dev), agent_wake])
        return bodies.replace(vel=vel, omega=omega), force, torque, wake

    # -- obs + reward + done (00.py:438-521) --------------------------------
    def _score(self, state, bodies, goal_contact, agent_dist, block_distance,
               block_angle, params):
        lay = self.layout
        s = C.V0_SCALE
        A = self.cfg.num_agents
        bc, ac = cm.centers(lay, bodies)
        E = bc.shape[-1]

        # per agent: (dx, dy) px, dist, contact
        rel = (ac - bc[None]) * s  # [A, 2, E]
        agent_obs = torch.cat(
            [rel, agent_dist[:, None], goal_contact[:, None].to(torch.float32)], dim=1
        ).reshape(A * 4, E)

        # block: relative to goal + angle diff + dist
        x = bc[0] * s
        y = bc[1] * s
        angle = torch.remainder(bodies.angle[lay.block_slot], TWO_PI)
        fx, fy, fangle = state.goal_pos[0], state.goal_pos[1], state.goal_pos[2]
        a_diff = torch.remainder(fangle, TWO_PI) - angle
        blk_obs = torch.stack([x - fx, y - fy, a_diff,
                               cm.distance(torch.stack([x, y]), state.goal_pos[:2])])

        verts = cm.block_world_vertices(lay, bodies) * s  # [8, 2, E] px
        obs = torch.cat([agent_obs, blk_obs, verts.reshape(-1, E)])

        # is_in_place ignores angle (quirk #4): both |dx|,|dy| <= EPSILON px
        in_place = (torch.abs(fx - x) <= C.V0_EPSILON) & (torch.abs(fy - y) <= C.V0_EPSILON)
        blks = in_place.to(torch.int32)

        reward = (state.block_distance - block_distance) * params.weight_delta_block * DS / 4.0
        reward = reward - params.weight_blk_dist * block_distance * DS / 4.0
        delta_agent = state.agent_dist - agent_dist
        reward = reward + (delta_agent * params.weight_delta_agent * DS / 4.0).sum(dim=0)
        reward = reward - (params.weight_agent_dist * agent_dist * DS / 4.0).sum(dim=0)
        reward = reward + 0.25 * goal_contact.sum(dim=0, dtype=torch.int32)

        reward = reward + (blks - state.blks_in_place) * C.V0_BLOCK_REWARD
        done = blks == 1
        reward = reward + torch.where(done, C.V0_FINAL_REWARD, 0.0)
        done_status = torch.where(done, 3, 0).to(torch.int32)
        return obs, reward.to(torch.float32), done, done_status, blks

    # -- what a fresh spawn is -------------------------------------------------
    def spawn_bad(self, s) -> torch.Tensor:
        """[E] bool: a state that is no fresh spawn (clock, velocities,
        contacts, awake flags, or a dynamic body outside the spawn box)."""
        lay = self.layout
        border = C.V0_BORDER
        pos = s.bodies.pos[lay.block_slot:]
        out = (pos < border - 1.0).any(dim=(0, 1))
        out |= (pos[:, 0] > lay.world_w - border + 1.0).any(0)
        out |= (pos[:, 1] > lay.world_h - border + 1.0).any(0)
        out |= s.t != 0
        out |= (s.bodies.vel != 0).any(dim=(0, 1)) | (s.bodies.omega != 0).any(0)
        out |= s.contacts.touching.any(0) | ~s.bodies.awake.all(0)
        return out


# the logic that ``portbench.check.RefEnv`` finds by the variant's name
Env = V0Env
