"""Env base: reset/step skeleton shared by the variants (port of
``gym_puzzles_tpu/envs/base.py``).

Every method works on the whole env batch, env axis last.  Randomness comes
from a ``torch.Generator`` the caller owns (the ``VectorEnv``), on the device
the state lives on.  The reference's ``reset`` takes one *random* action and
returns that step's observation (00.py:411 -- SURVEY quirk #1);
:meth:`reset_spawn` returns the spawned state and that action so the vector
env can run it through the same step as training.
"""

from __future__ import annotations

import torch

from gym_puzzles_tpu_torch.engine import world as eng
from gym_puzzles_tpu_torch.envs import common as cm
from gym_puzzles_tpu_torch.envs import layout as lay
from gym_puzzles_tpu_torch.envs.config import EnvConfig, RewardParams
from gym_puzzles_tpu_torch.utils.profiling import device_span


class PuzzleEnvLogic:
    """Batched env logic.  Subclasses implement ``_spawn``, ``_distances``,
    ``_control`` and ``_score``; engine plumbing, contact flags and the
    reset-random-step quirk live here."""

    def __init__(self, cfg: EnvConfig):
        self.cfg = cfg
        self.layout, self.wall_positions = lay.build(cfg)

    # -- subclass interface ------------------------------------------------
    def _spawn(self, gen: torch.Generator, num_envs: int):
        """-> (Bodies, goal_pos [3, E])"""
        raise NotImplementedError

    def _distances(self, bodies, goal_pos):
        """-> (agent_dist [A, E], block_distance [E], block_angle [E])"""
        raise NotImplementedError

    def _control(self, state, action):
        """-> (Bodies with velocity-type controls applied, force [B, 2, E],
        torque [B, E], wake [B, E] bool)"""
        raise NotImplementedError

    def _score(self, state, bodies, goal_contact, agent_dist, block_distance,
               block_angle, params):
        """-> (obs [obs_dim, E], reward [E], done [E], done_status [E], blks [E])"""
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    def default_params(self) -> RewardParams:
        return RewardParams.default(self.cfg.variant)

    def reset_spawn(self, gen: torch.Generator, num_envs: int):
        """Spawn fresh episode states plus the reference reset contract's
        uniform random action [act_dim, E] (00.py:411)."""
        bodies, goal_pos = self._spawn(gen, num_envs)
        state = self.state_from_bodies(bodies, goal_pos)
        action = cm.uniform(gen, -1.0, 1.0, (self.cfg.act_dim, num_envs))
        return state, action

    def state_from_bodies(self, bodies, goal_pos):
        """Fresh EnvState around given body state (no contacts, flags off,
        distances computed)."""
        E = bodies.angle.shape[-1]
        dev = bodies.angle.device
        contacts = eng.init_contacts(self.layout.table, E, dev)
        agent_dist, block_distance, block_angle = self._distances(bodies, goal_pos)
        A = self.cfg.num_agents
        zeros_i = torch.zeros((E,), dtype=torch.int32, device=dev)
        return cm.EnvState(
            bodies=bodies,
            contacts=contacts,
            goal_contact=torch.zeros((A, E), dtype=torch.bool, device=dev),
            wall_contact=torch.zeros((E,), dtype=torch.bool, device=dev),
            agent_dist=agent_dist,
            block_distance=block_distance,
            block_angle=block_angle,
            blks_in_place=zeros_i,
            goal_pos=goal_pos,
            t=zeros_i.clone(),
            done_status=zeros_i.clone(),
        )

    def inject(self, origin_positions, angles, goal_pos):
        """Build an EnvState from explicit body-origin poses [B, 2, E] and
        angles [B, E] -- the entry point for mirroring another world."""
        bodies = eng.init_bodies(self.layout.table, origin_positions, angles)
        goal_pos = torch.as_tensor(goal_pos, dtype=torch.float32, device=bodies.angle.device)
        return self.state_from_bodies(bodies, goal_pos)

    def observe(self, state: cm.EnvState, params: RewardParams):
        """The observation of a state that has not stepped yet (what
        :meth:`reset_fast` returns)."""
        obs, _r, _d, _s, _b = self._score(
            state, state.bodies, state.goal_contact, state.agent_dist,
            state.block_distance, state.block_angle, params,
        )
        return obs

    def reset_fast(self, gen: torch.Generator, num_envs: int, params: RewardParams):
        """Spawn only -- observation computed directly from the spawned
        state, skipping the reference's random-action step.  Same state
        distribution up to one step; used by the autoreset path."""
        bodies, goal_pos = self._spawn(gen, num_envs)
        state = self.state_from_bodies(bodies, goal_pos)
        return state, self.observe(state, params)

    def fused_logic(self, device) -> bool:
        """Whether a state on ``device`` takes hand-written kernels for the
        env logic around the tick (``_control``, ``_finish``) and the fast
        autoreset's spawn (``step_fused(..., respawn=)``).  None here: the
        plain PyTorch ops."""
        return False

    def step_fused(self, state: cm.EnvState, action, params: RewardParams, respawn=None):
        """Batched step (action [act_dim, E]) with each engine tick in the
        fused CUDA kernel on the card, or the plain ``world.step`` on the
        CPU.  Returns (state, obs [obs_dim, E], reward, done, info).  Device
        spans: ``env.control``, ``env.tick`` at each tick (``step_cuda``),
        ``env.score``.

        ``respawn``, a generator, takes the fast autoreset into the step (a
        logic whose :meth:`fused_logic` holds): the spawn's uniforms are
        drawn from it for every env (device span ``env.autoreset``), and the
        envs that end come back freshly spawned, with their new obs."""
        return self._step_with(state, action, params, cm.physics_fused, respawn)

    def _step_with(self, state: cm.EnvState, action, params: RewardParams, physics,
                   respawn=None):
        dev = action.device
        with device_span("env.control", dev):
            bodies, force, torque, wake = self._control(state, action)
        bodies, contacts, goal_contact, wall_contact = physics(
            self.layout, self.cfg, bodies, state.contacts, force, torque, wake,
            state.goal_contact, state.wall_contact,
        )
        draws = None
        if respawn is not None:
            if not self.fused_logic(dev):
                raise ValueError(f"{type(self).__name__} on {dev} has no fused respawn")
            with device_span("env.autoreset", dev):
                draws = self._spawn_draws(respawn, action.shape[-1])
        with device_span("env.score", dev):
            return self._finish(state, bodies, contacts, goal_contact, wall_contact, params,
                                draws)

    def step_batched(self, state: cm.EnvState, action, params: RewardParams, respawn=None):
        """:meth:`step_fused` with each engine tick staged instead: the
        narrow phase and bookkeeping as PyTorch ops around the CUDA
        contact-solve kernel (the plain solve on the CPU)."""
        return self._step_with(state, action, params, cm.physics_batched, respawn)

    def _finish(self, state, bodies, contacts, goal_contact, wall_contact,
                params: RewardParams, draws=None):
        """Post-physics: distances, obs, reward, termination, state assembly
        (the plain version; ``draws`` are a fused respawn's, which it does
        not take)."""
        if draws is not None:
            raise ValueError("the plain env logic takes no respawn draws")
        agent_dist, block_distance, block_angle = self._distances(bodies, state.goal_pos)
        obs, reward, done, done_status, blks = self._score(
            state, bodies, goal_contact, agent_dist, block_distance, block_angle, params
        )
        t = state.t + 1
        truncated = t >= self.cfg.max_episode_steps  # gym TimeLimit wrapper
        new_state = cm.EnvState(
            bodies=bodies,
            contacts=contacts,
            goal_contact=goal_contact,
            wall_contact=wall_contact,
            agent_dist=agent_dist,
            block_distance=block_distance,
            block_angle=block_angle,
            blks_in_place=blks,
            goal_pos=state.goal_pos,
            t=t,
            done_status=done_status,
        )
        info = {"done_status": done_status, "truncated": truncated, "t": t}
        return new_state, obs, reward, done | truncated, info
