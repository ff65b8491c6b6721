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

from gym_puzzles_tpu_torch.engine import world as eng
from gym_puzzles_tpu_torch.engine.types import device_const
from gym_puzzles_tpu_torch.envs import common as cm
from gym_puzzles_tpu_torch.envs import config as C
from gym_puzzles_tpu_torch.envs import v0_cuda
from gym_puzzles_tpu_torch.envs.base import PuzzleEnvLogic

DS = 1.0  # downsample factor (00.py:38); kept explicit in the reward math
TWO_PI = 2.0 * math.pi
POW_BASE = 1.1  # the soft force's 1.1^(-agent_dist)
CONTACT_REWARD = 0.25  # per agent touching the block


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
        return self._spawn_from(self._spawn_draws(gen, num_envs))

    def _spawn_draws(self, gen, num_envs):
        """The spawn's uniforms in [0, 1), in the order drawn: the block's x,
        y and angle [E] each, the agents' positions [A, 2, E]."""
        E = num_envs
        return (cm.draw(gen, (E,)), cm.draw(gen, (E,)), cm.draw(gen, (E,)),
                cm.draw(gen, (self.cfg.num_agents, 2, E)))

    def spawn_bounds(self):
        """(lo, hi) of the block's x, y and angle and of the agents' (x, y):
        Python floats, and for the agents a float32 [2] hi."""
        w, h, b = self.layout.world_w, self.layout.world_h, C.V0_BORDER
        return ((b, w - b), (b, h - b), (0.0, 2.0 * np.pi),
                (b, np.array([w - b, h - b], np.float32)))

    def _spawn_from(self, draws):
        """(Bodies, goal_pos [3, E]) of the spawn that ``draws`` (what
        :meth:`_spawn_draws` returns) place."""
        lay = self.layout
        ubx, uby, uang, uaxy = draws
        A, E = self.cfg.num_agents, ubx.shape[-1]
        dev = ubx.device
        (bx_lo, bx_hi), (by_lo, by_hi), (ang_lo, ang_hi), (a_lo, a_hi) = self.spawn_bounds()
        bx = cm.scale(ubx, bx_lo, bx_hi)
        by = cm.scale(uby, by_lo, by_hi)
        bang = cm.scale(uang, ang_lo, ang_hi)
        axy = cm.scale(uaxy, a_lo, device_const(a_hi, dev)[:, None])

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

    # -- the hand-written kernels on the card (envs/v0_cuda.py) -------------
    def fused_logic(self, device) -> bool:
        """A state on a CUDA device takes the kernels of ``envs/v0_cuda.py``:
        ``control`` in :meth:`_control`, ``score_respawn`` in :meth:`_finish`."""
        return torch.device(device).type == "cuda"

    def _control(self, state, action):
        if self.fused_logic(action.device):
            return v0_cuda.control(self, state, action)
        return self._control_plain(state, action)

    def _finish(self, state, bodies, contacts, goal_contact, wall_contact, params, draws=None):
        if self.fused_logic(bodies.angle.device):
            return v0_cuda.score_respawn(self, state, bodies, contacts, goal_contact,
                                         wall_contact, params, draws)
        return super()._finish(state, bodies, contacts, goal_contact, wall_contact, params,
                               draws)

    # -- control (00.py:415-424): velocity set + soft assist ----------------
    def _control_plain(self, state, action):
        """The plain version of the ``control`` kernel: what the CPU runs."""
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
        mag = torch.pow(POW_BASE, -state.agent_dist)  # [A, E]
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
        reward = reward + CONTACT_REWARD * goal_contact.sum(dim=0, dtype=torch.int32)

        reward = reward + (blks - state.blks_in_place) * C.V0_BLOCK_REWARD
        done = blks == 1
        reward = reward + torch.where(done, C.V0_FINAL_REWARD, 0.0)
        done_status = torch.where(done, 3, 0).to(torch.int32)
        return obs, reward.to(torch.float32), done, done_status, blks
