"""Drop-in adapters for external trainers (port of
``gym_puzzles_tpu/api/gym_compat.py``).

``GymPuzzleEnv`` -- one env with the old-Gym 0.21 calling convention the
reference registers (reset() -> obs, step(a) -> (obs, reward, done, info),
seed(), render(mode), and the reward-tuning hooks set_reward_params /
update_params / update_goal, 00.py:231-246).  numpy in, numpy out, so
SB3-style code can switch from ``gym.make('MultiRobotPuzzle-v0')`` to
``GymPuzzleEnv('MultiRobotPuzzle-v0')``.

The port's env logic keeps the env axis last and has no single-env path, so
the env is a one-env :class:`~gym_puzzles_tpu_torch.api.vector.VectorEnv`
(no autoreset, the reference reset, the fused tick): on the card every
``step`` is one launch of the fused tick kernel, and ``reset`` one more (the
reference reset's random step).  The env's ``torch.Generator`` stands in for
the JAX package's PRNG key, so spawns differ from the JAX package's.

``GymnasiumVectorAdapter`` -- a gymnasium.vector-style wrapper around the
batched env (reset(seed) -> (obs, info), step -> 5-tuple with terminated /
truncated split).
"""

from __future__ import annotations

import numpy as np
import torch

from gym_puzzles_tpu_torch.api.registry import make
from gym_puzzles_tpu_torch.api.vector import _box_space
from gym_puzzles_tpu_torch.envs import config as C
from gym_puzzles_tpu_torch.envs.config import _f32


class GymPuzzleEnv:
    metadata = {"render.modes": ["human", "rgb_array", "agent"], "video.frames_per_second": 50}

    def __init__(self, env_id: str, seed: int | None = None, device=None, **make_kw):
        """``device`` defaults to ``cuda`` (with no CUDA and no device named
        this raises); ``make_kw`` are :func:`make`'s env options
        (``block_shape``, ``velocity_iters``, ...)."""
        self._env = make(env_id, num_envs=1, auto_reset=False, reset_mode="reference",
                         backend="fused", device=device, **make_kw)
        self._logic = self._env.logic
        self.spec_cfg = self._env.cfg
        self.device = self._env.device
        self._params = self._env.default_params()
        self._state = None
        self._viewer = None
        self.seed(seed)
        self.observation_space = _box_space(self.spec_cfg.obs_dim)
        self.action_space = _box_space(self.spec_cfg.act_dim, low=-1.0, high=1.0)

    # -- old gym API --------------------------------------------------------
    def seed(self, seed=None):
        self._env.generator.manual_seed(0 if seed is None else int(seed))
        return [seed]

    def reset(self):
        self._state, obs = self._env.reset(seed=None, params=self._params)
        return obs[0].cpu().numpy()

    def step(self, action):
        action = torch.as_tensor(np.asarray(action, np.float32)[None], device=self.device)
        self._state, obs, reward, done, info = self._env.step(self._state, action, self._params)
        r, d, status = torch.stack([reward[0], done[0].float(),
                                    info["done_status"][0].float()]).tolist()
        return obs[0].cpu().numpy(), r, bool(d), {"done_status": int(status)}

    def render(self, mode="human"):
        from gym_puzzles_tpu_torch.render.raster import render_batch

        style = "agent_vision" if mode == "agent" else "human_vision"
        frame = render_batch(self._logic, self._state, [0], mode=style)[0]
        if mode in ("rgb_array", "state_pixels", "agent"):
            return frame
        # mode='human': live display (the reference's pyglet viewer,
        # 00.py:528-534) -- an interactive matplotlib window when a display
        # exists, ANSI terminal frames otherwise (render/window.py)
        if self._viewer is None:
            from gym_puzzles_tpu_torch.render.window import LiveViewer

            self._viewer = LiveViewer()
        self._viewer.show(frame)
        return frame

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None

    # -- reference reward-tuning hooks (00.py:231-246) ----------------------
    def set_reward_params(self, agentDelta=None, agentDistance=None, blockDelta=None,
                          blockDistance=None, puzzleComp=None, outOfBounds=None,
                          blkOutOfBounds=None):
        """Override the given base weights only (the ``shaped_*`` copies stay
        as they are, as in the JAX class)."""
        given = dict(agentDelta=agentDelta, agentDistance=agentDistance, blockDelta=blockDelta,
                     blockDistance=blockDistance, puzzleComp=puzzleComp,
                     outOfBounds=outOfBounds, blkOutOfBounds=blkOutOfBounds)
        self._params = self._params.replace(**{
            C.RewardParams.REFERENCE_WEIGHT_NAMES[k]: _f32(v)
            for k, v in given.items() if v is not None})

    def update_params(self, timestep, decay):
        self._params = self._params.update_params(timestep, decay)

    def update_goal(self, epoch, nb_epochs):
        base = {"v0": C.V0_EPSILON, "v2": C.V2_EPSILON, "v3": C.V3_EPSILON}[
            self.spec_cfg.variant
        ]
        self._params = self._params.update_goal(epoch, nb_epochs, base)


class GymnasiumVectorAdapter:
    """gymnasium.vector-style API over the batched env; ``make_kw`` go to
    :func:`make` (``device`` among them: default ``cuda``)."""

    def __init__(self, env_id: str, num_envs: int, **make_kw):
        self.env = make(env_id, num_envs=num_envs, **make_kw)
        self.num_envs = num_envs
        self._params = self.env.default_params()
        self._state = None
        self.single_observation_space = self.env.single_observation_space
        self.single_action_space = self.env.single_action_space

    def reset(self, seed=None, options=None):
        self._state, obs = self.env.reset(seed=0 if seed is None else seed, params=self._params)
        return obs.cpu().numpy(), {}

    def step(self, actions):
        self._state, obs, reward, done, info = self.env.step(
            self._state, np.asarray(actions, np.float32), self._params)
        truncated = info["truncated"].cpu().numpy()
        terminated = done.cpu().numpy() & ~truncated
        return (obs.cpu().numpy(), reward.cpu().numpy(), terminated, truncated,
                {"done_status": info["done_status"].cpu().numpy()})

    def close(self):
        pass
