"""MultiRobotPuzzle-v3 (port of ``gym_puzzles_tpu/envs/v3.py``).

The modular v0 variant (RobotPuzzleBase, core.py): normalized observations
in ~[-1, 1], velocity-set robots (max speed 5), a fixed goal at
(5/6*W - 4/3*border, H/2) px, distance-threshold completion worth +100, and
the aspect-skewed y normalization (core.py:289-295 divides y by the *width*
scale -- SURVEY quirk #11).  ``num_agents`` and ``heavy`` come from the
config (the registry's v3 constructor surface).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gym_puzzles_tpu_torch.engine import world as eng
from gym_puzzles_tpu_torch.engine.types import device_const
from gym_puzzles_tpu_torch.envs import common as cm
from gym_puzzles_tpu_torch.envs import config as C
from gym_puzzles_tpu_torch.envs.base import PuzzleEnvLogic

TWO_PI = 2.0 * math.pi


class V3Env(PuzzleEnvLogic):
    def __init__(self, cfg):
        super().__init__(cfg)
        w, h = C.V3_SCREEN_W, C.V3_SCREEN_H
        # core.py:277-281
        self.goal_px = np.array(
            [5.0 / 6.0 * w - 4.0 / 3.0 * C.V3_BORDER, h // 2, 0.0], np.float32
        )
        self.width_scale = w / C.V3_SCALE / 2.0  # 10.6667
        self.height_scale = h / C.V3_SCALE / 2.0  # 8.0
        # goal in normalized units (core.py:332-336)
        self.goal_norm = np.array(
            [
                (self.goal_px[0] - w / 2.0) / (w / 2.0),
                (self.goal_px[1] - h / 2.0) / (w / 2.0),
                0.0,
            ],
            np.float32,
        )

    def _norm_pose(self, xy, rot):
        """core.py:289-295: x, y centered and divided by width_scale (y too!).
        ``xy`` [..., 2, E], ``rot`` [..., E]."""
        ws, hs = self.width_scale, self.height_scale
        x = (xy[..., 0, :] - ws) / ws
        y = (xy[..., 1, :] - hs) / ws
        return x, y, torch.remainder(rot, TWO_PI)

    # -- spawn (core.py:204-243) -------------------------------------------
    def _spawn(self, gen, num_envs):
        lay = self.layout
        A, E = self.cfg.num_agents, num_envs
        dev = gen.device
        w, h = lay.world_w, lay.world_h
        b = C.V3_BORDER

        bx = cm.uniform(gen, w / 3.0 + 2.0 * b, w * 2.0 / 3.0 - 2.0 * b, (E,))
        by = cm.uniform(gen, 3.0 * b, h - 3.0 * b, (E,))
        bang = cm.uniform(gen, 0.0, 2.0 * np.pi, (E,))
        hi = device_const(np.array([w / 3.0 - 2.0 * b, h - b], np.float32), dev)[:, None]
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
        goal = device_const(self.goal_norm, dev)[:, None].expand(3, E).clone()
        return bodies, goal

    # -- distances in normalized units (core.py:297-350) --------------------
    def _distances(self, bodies, goal_pos):
        lay = self.layout
        bc, ac = cm.centers(lay, bodies)
        a0 = int(lay.agent_slots[0])
        bx, by, brot = self._norm_pose(bc, bodies.angle[lay.block_slot])
        axx, ayy, _ = self._norm_pose(ac, bodies.angle[a0:a0 + lay.num_agents])
        dx, dy = axx - bx, ayy - by
        agent_dist = torch.sqrt(dx * dx + dy * dy)
        gx, gy = goal_pos[0] - bx, goal_pos[1] - by
        block_distance = torch.sqrt(gx * gx + gy * gy)
        block_angle = torch.remainder(goal_pos[2], TWO_PI) - brot
        return agent_dist, block_distance, block_angle

    # -- control (core.py:353-364, robot.py:65-68) --------------------------
    def _control(self, state, action):
        lay = self.layout
        A = self.cfg.num_agents
        E = action.shape[-1]
        a = action.reshape(A, 3, E)
        vel_set = a[:, :2] * C.V3_AGENT_MAX_SPEED
        omega_set = a[:, 2]

        bodies = state.bodies
        vel = cm.set_agent_rows(lay, bodies.vel, vel_set)
        omega = cm.set_agent_rows(lay, bodies.omega, omega_set)

        bc, ac = cm.centers(lay, bodies)
        mag = torch.pow(1.1, -state.agent_dist)
        unit = cm.chebyshev_unit(ac, bc[None])
        block_force = (mag[:, None] * unit).sum(dim=0)

        force = cm.body_rows(lay, block_force, torch.zeros_like(vel_set))
        torque = torch.zeros_like(bodies.omega)

        agent_wake = (vel_set[:, 0] * vel_set[:, 0] + vel_set[:, 1] * vel_set[:, 1]) > 0.0
        agent_wake = agent_wake | (omega_set * omega_set > 0.0)
        dev = action.device
        wake = torch.cat([torch.zeros((4, E), dtype=torch.bool, device=dev),
                          torch.ones((1, E), dtype=torch.bool, device=dev), agent_wake])
        return bodies.replace(vel=vel, omega=omega), force, torque, wake

    # -- obs + reward + done (core.py:297-414) ------------------------------
    def _score(self, state, bodies, goal_contact, agent_dist, block_distance,
               block_angle, params):
        lay = self.layout
        A = self.cfg.num_agents
        bc, ac = cm.centers(lay, bodies)
        E = bc.shape[-1]
        a0 = int(lay.agent_slots[0])
        bx, by, brot = self._norm_pose(bc, bodies.angle[lay.block_slot])
        axx, ayy, arot = self._norm_pose(ac, bodies.angle[a0:a0 + A])

        agent_obs = torch.stack(
            [bx - axx, by - ayy, arot, goal_contact.to(torch.float32)], dim=1
        ).reshape(A * 4, E)

        gx, gy = state.goal_pos[0], state.goal_pos[1]
        grot = torch.remainder(state.goal_pos[2], TWO_PI)
        blk_obs = torch.stack([gx - bx, gy - by, grot - brot])

        verts = cm.block_world_vertices(lay, bodies)  # [V, 2, E] world meters
        ws, hs = self.width_scale, self.height_scale
        verts_n = torch.stack([(verts[:, 0] - ws) / ws, (verts[:, 1] - hs) / ws], dim=1)
        obs = torch.cat([agent_obs, blk_obs, verts_n.reshape(-1, E)])

        # completion: distance threshold, no blocks-in-place counter
        # (core.py:376: EPSILON / screen_width * 2)
        thresh = C.V3_EPSILON / C.V3_SCREEN_W * 2.0
        in_place = block_distance <= thresh

        reward = (state.block_distance - block_distance) * params.weight_delta_block
        reward = reward - params.weight_blk_dist * block_distance
        delta_agent = state.agent_dist - agent_dist
        reward = reward + (delta_agent * params.weight_delta_agent / 4.0).sum(dim=0)
        reward = reward - (params.weight_agent_dist * agent_dist / 4.0).sum(dim=0)
        reward = reward + 0.25 * goal_contact.sum(dim=0, dtype=torch.int32)

        done = in_place
        # core.py:410 adds the *unshaped* puzzle_complete_reward (=100)
        reward = reward + torch.where(done, params.puzzle_complete_reward, 0.0)
        done_status = torch.where(done, 3, 0).to(torch.int32)
        blks = in_place.to(torch.int32)
        return obs, reward.to(torch.float32), done, done_status, blks
