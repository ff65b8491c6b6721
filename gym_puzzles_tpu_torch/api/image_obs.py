"""v0 image-observation pipeline (port of ``gym_puzzles_tpu/api/image_obs.py``).

The reference's ``obs_type='image'`` capability: stacked
``(h * obs_depth, w, 3)`` uint8 frames with frameskip 4
(multi_robot_puzzle_00.py:161-162,197-200), declared but off by default
there.  Two implementations, whose physics steps through the port's
:class:`~gym_puzzles_tpu_torch.api.vector.VectorEnv` (by default the fused
tick kernel, ``frameskip`` launches per step):

* :class:`ImageObsEnv` -- one env, old-Gym API, frames rasterized on the
  host (``render/raster.py``) from the state after each step;
* :class:`DeviceImageVectorEnv` -- thousands of envs render their frames on
  the device (``render/device.py``) after every step and carry their frame
  stacks there, so a CNN policy trains on pixels with no host round trip.
  On a CUDA device its step -- ``frameskip`` ticks, the render of the
  post-autoreset state and the frame-stack shift -- replays one CUDA graph,
  the counterpart of the JAX package's jitted image step
  (``image_obs.py:135,143``).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from gym_puzzles_tpu_torch.api.registry import _image_logic
from gym_puzzles_tpu_torch.api.vector import VectorEnv
from gym_puzzles_tpu_torch.engine.types import Replaceable
from gym_puzzles_tpu_torch.envs.common import EnvState
from gym_puzzles_tpu_torch.render.device import make_device_renderer
from gym_puzzles_tpu_torch.utils.cuda_graph import GraphedStep, weak_call
from gym_puzzles_tpu_torch.utils.profiling import device_span, span


class ImageObsEnv:
    """Single-env image-observation variant of MultiRobotPuzzle-v0: obs are
    ``obs_depth`` stacked host-rendered frames ``(h * obs_depth, w, 3)``
    uint8, oldest first, zero-padded after a reset; each step runs
    ``frameskip`` engine ticks.  The env is a one-env ``VectorEnv`` (no
    autoreset, the reference reset, the fused tick) on ``device`` (default
    ``cuda``; with no CUDA and no device named this raises), seeded by
    ``seed``."""

    def __init__(self, env_id: str = "MultiRobotPuzzle-v0", obs_depth: int = 3,
                 frameskip: int = 4, downsample: int = 1, seed: int = 0, device=None,
                 velocity_iters: int | None = None, position_iters: int | None = None):
        logic = _image_logic(env_id, frameskip, "t", velocity_iters, position_iters)
        if logic.cfg.variant != "v0":
            raise ValueError(f"image obs is a v0 capability, got {env_id}")
        self._env = VectorEnv(logic, 1, auto_reset=False, reset_mode="reference",
                              device=device, backend="fused")
        self._env.generator.manual_seed(int(seed))
        self._logic = logic
        self._params = self._env.default_params()
        self._state = None
        self.device = self._env.device
        self.obs_depth = obs_depth
        self.downsample = downsample
        self._frames = collections.deque(maxlen=obs_depth)
        self.observation_shape = (480 // downsample * obs_depth, 640 // downsample, 3)

    def _frame(self):
        from gym_puzzles_tpu_torch.render.raster import render_batch

        img = render_batch(self._logic, self._state, [0])[0]
        if self.downsample > 1:
            img = img[:: self.downsample, :: self.downsample]
        return img

    def _obs(self):
        while len(self._frames) < self.obs_depth:
            self._frames.appendleft(np.zeros_like(self._frames[0]))
        return np.concatenate(list(self._frames), axis=0)

    def reset(self):
        self._state, _obs = self._env.reset(seed=None, params=self._params)
        self._frames.clear()
        self._frames.append(self._frame())
        return self._obs()

    def step(self, action):
        action = torch.as_tensor(np.asarray(action, np.float32)[None], device=self.device)
        self._state, _obs, reward, done, info = self._env.step(self._state, action, self._params)
        self._frames.append(self._frame())
        return self._obs(), float(reward[0]), bool(done[0]), {
            "done_status": int(info["done_status"][0]),
        }


@dataclasses.dataclass
class ImageVectorState(Replaceable):
    """The batched env state and the frame stacks."""

    vec: EnvState  # env axis last
    frames: torch.Tensor  # [E, obs_depth, h, w, 3] uint8, oldest first


class DeviceImageVectorEnv:
    """Batched image-obs env with rendering on the device; duck-typed to
    :class:`VectorEnv` (``reset`` / ``step`` / ``default_params``,
    ``generator``, ``device``, ``cfg``, ``logic``) so PPO drives it unchanged.

    Obs are the reference's stacked frame layout, batched:
    ``[E, h * obs_depth, w, 3]`` uint8, oldest frame first, zero-padded at
    episode starts.  Physics honours the image mode's ``frameskip`` (default
    4).  Runs on ``device`` (default ``cuda``; with no CUDA and no device
    named this raises)."""

    def __init__(self, env_id: str = "MultiRobotPuzzle-v0", num_envs: int = 8,
                 obs_depth: int = 3, frameskip: int = 4, downsample: int = 4,
                 backend: str = "fused", mode: str = "human_vision",
                 block_shape: str = "t", auto_reset: bool = True,
                 reset_mode: str = "fast", velocity_iters: int | None = None,
                 position_iters: int | None = None, device=None):
        logic = _image_logic(env_id, frameskip, block_shape, velocity_iters, position_iters)
        self._env = VectorEnv(logic, num_envs, auto_reset=auto_reset, reset_mode=reset_mode,
                              device=device, backend=backend)
        self.logic = logic
        self.cfg = logic.cfg
        self.num_envs = int(num_envs)
        self.device = self._env.device
        self.obs_depth = obs_depth
        # the pipeline's config, so that evaluation rebuilds the training obs
        self.frameskip = frameskip
        self.downsample = downsample
        self.mode = mode
        self.block_shape = block_shape
        self.render = make_device_renderer(logic, downsample=downsample, mode=mode)
        self.frame_shape = (self.render.height, self.render.width, 3)
        self.obs_shape = (self.render.height * obs_depth, self.render.width, 3)
        self._graph = None  # GraphedStep of step_eager, made at the first CUDA step

    @property
    def generator(self) -> torch.Generator:
        """The env's own generator (spawns), seeded by :meth:`reset`."""
        return self._env.generator

    @property
    def image_pipeline(self) -> tuple:
        """(obs_depth, frameskip, downsample, mode, block_shape)."""
        return (self.obs_depth, self.frameskip, self.downsample, self.mode, self.block_shape)

    def default_params(self):
        return self._env.default_params()

    @property
    def graph_pool(self):
        """The memory pool of this env's CUDA graphs (the inner env's)."""
        return self._env.graph_pool

    def close(self):
        """Release the env's CUDA graph (a later step captures anew)."""
        if self._graph is not None:
            self._graph.close()
            self._graph = None

    def stack_obs(self, frames):
        """[E, depth, h, w, 3] frames -> [E, depth * h, w, 3] obs."""
        return frames.reshape((frames.shape[0],) + self.obs_shape)

    def reset(self, seed: int = 0, params=None):
        """Seed the env's generator and spawn every env.  Returns
        (ImageVectorState, obs): ``obs_depth - 1`` zero frames, then the
        rendered first frame."""
        vec, _obs = self._env.reset(seed, params)
        frame = self.render(vec)
        frames = torch.zeros((self.num_envs, self.obs_depth) + self.frame_shape,
                             dtype=torch.uint8, device=self.device)
        frames[:, -1] = frame
        return ImageVectorState(vec=vec, frames=frames), self.stack_obs(frames)

    def step(self, istate: ImageVectorState, action, params=None):
        """action: [E, act_dim].  Returns (istate, obs, reward [E], done [E],
        info).  The frame is rendered from the state after autoreset; where
        ``done``, the stack starts afresh (zero-padded), elsewhere it shifts
        by one frame.  Spans (``utils/profiling.py``): the host span
        ``env.step``; on the device the physics' (``VectorEnv``) and
        ``env.render`` (the frame and the stack).

        On a CUDA device this replays the env's CUDA graph of
        :meth:`step_eager` (captured at the first step); on the CPU it is
        :meth:`step_eager`.  What a step returns is its own, as for
        ``VectorEnv.step``."""
        with span("env.step", step=True):
            params = self.default_params() if params is None else params
            act = torch.as_tensor(action, dtype=torch.float32, device=self.device)
            if self.device.type != "cuda":
                return self.step_eager(istate, act, params)
            if self._graph is None:
                self._graph = GraphedStep(weak_call(self.step_eager), self.device,
                                          (self.generator,), self.graph_pool, name="env.step")
            return self._graph(istate, act, params)

    def step_eager(self, istate: ImageVectorState, action, params=None):
        """:meth:`step` as eager PyTorch ops and kernel launches: the physics
        through ``VectorEnv.step_eager`` (no graph within the graph), then the
        render and the frame stack.  What the CUDA graph captures, what the
        CPU runs, and what a replay is held against."""
        vec, _obs, reward, done, info = self._env.step_eager(istate.vec, action, params)
        with device_span("env.render", self.device):
            frame = self.render(vec)
            older = torch.where(done[:, None, None, None, None], 0, istate.frames[:, 1:])
            frames = torch.cat([older, frame[:, None]], dim=1)
        return (ImageVectorState(vec=vec, frames=frames), self.stack_obs(frames),
                reward, done, info)
