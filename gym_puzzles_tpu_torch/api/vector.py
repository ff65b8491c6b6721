"""Batched env: thousands of envs stepped in lockstep on one device.

Port of ``gym_puzzles_tpu/api/vector.py``.  State tensors keep the env batch
on their trailing axis; the public observation, action and reward are
batch-first.  Randomness comes from a ``torch.Generator`` owned by the
``VectorEnv`` (seeded by :meth:`VectorEnv.reset`) in place of the JAX
package's per-env PRNG keys.

Reset semantics are selectable:

* ``reset_mode='reference'`` -- reset takes one uniform random action and
  returns that step's observation, the reference contract (00.py:411).
  Costs one physics step per reset.
* ``reset_mode='fast'`` (default) -- reset returns the spawned state's
  observation directly.  Same distribution over states up to one random
  step; used for training/benchmarking where autoreset would otherwise pay
  a second physics step on every env every step.

The engine tick behind a step is selectable too:

* ``backend='fused'`` (default) -- the whole tick in one launch of the fused
  CUDA kernel (``engine/step_cuda.py``).
* ``backend='pallas'`` -- the staged tick, named as in the JAX package: the
  narrow phase, islands and sleep bookkeeping as PyTorch ops around one
  launch of the CUDA contact-solve kernel (``engine/solver_cuda.py``).

On the CPU both run the plain PyTorch engine.

On a CUDA device :meth:`VectorEnv.step` replays a CUDA graph, the
counterpart of the JAX package's jitted step (``vector.py:117``): the first
step captures :meth:`VectorEnv.step_eager` (``utils/cuda_graph.py``), every
step after replays it.  The state, obs, reward, done and info a step returns
are the step's own (a later step changes none of them); a state passed back
as it was returned is not copied again.  Reward parameters reach the graph
through a device buffer, so a changed ``RewardParams`` needs no new capture.
Autoreset spawns draw from :attr:`VectorEnv.generator`, registered with the
graph: a replay draws what the eager step would, and ``reset(seed=)``
reseeds them.  :meth:`reset` stays eager.

At v0 and Heavy-v0 on the card the env logic around the tick is two
hand-written kernels (``envs/v0_cuda.py``), and the fast autoreset goes into
the second (:attr:`VectorEnv.fused_respawn`): the spawn's uniforms are drawn
for every env as before, and only the envs that end are spawned, in place.

Spans (``utils/profiling.py``, recorded with tracing on): a step is the host
span ``env.step`` (around the graph's ``graph.inputs`` / ``graph.launch`` /
``graph.outputs``), and on the device ``env.control``, ``env.tick`` and
``env.score`` (``envs/base.py``) and ``env.autoreset`` (the spawn and the
selects; with the fused respawn the spawn's four draws, the spawns
themselves in ``env.score``).  After the span, every
:data:`LIVE_PAIRS_EVERY`-th step of a tracing block records kernel A's load
on the state it returns (``profiling.LIVE_PAIRS``, site ``env.step``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gym_puzzles_tpu_torch.envs import common as cm
from gym_puzzles_tpu_torch.envs.base import PuzzleEnvLogic
from gym_puzzles_tpu_torch.envs.config import RewardParams
from gym_puzzles_tpu_torch.utils.cuda_graph import GraphedStep, weak_call
from gym_puzzles_tpu_torch.utils.profiling import count_live_pairs, device_span, span

LIVE_PAIRS_EVERY = 25  # traced steps per record of kernel A's load


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: ``cuda`` unless the caller names one.
    With no device named and no CUDA, this raises: the port never moves
    onto the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch engine on the CPU"
        )
    return torch.device("cuda")


BACKENDS = ("fused", "pallas")


class VectorEnv:
    """Batched env on one device: state in, state out."""

    def __init__(self, logic: PuzzleEnvLogic, num_envs: int, auto_reset: bool = True,
                 reset_mode: str = "fast", device=None, backend: str = "fused"):
        if reset_mode not in ("fast", "reference"):
            raise ValueError(f"reset_mode must be 'fast' or 'reference', got {reset_mode!r}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.backend = backend
        self._step = logic.step_fused if backend == "fused" else logic.step_batched
        self.logic = logic
        self.cfg = logic.cfg
        self.num_envs = int(num_envs)
        self.auto_reset = auto_reset
        self.reset_mode = reset_mode
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self._graph = None  # GraphedStep of step_eager, made at the first CUDA step

    @functools.cached_property
    def graph_pool(self):
        """The memory pool of this env's CUDA graphs (and of graphs built
        around it, such as the learner's rollout); it goes with the env."""
        return torch.cuda.graph_pool_handle()

    def close(self):
        """Release the env's CUDA graph (a later step captures anew)."""
        if self._graph is not None:
            self._graph.close()
            self._graph = None

    def default_params(self) -> RewardParams:
        return self.logic.default_params()

    def _reset_batch(self, params):
        """Fresh states and their observations ([obs_dim, E]) for every env.
        In reference mode the quirk's random step runs through the same
        engine step as training."""
        if self.reset_mode != "reference":
            return self.logic.reset_fast(self.generator, self.num_envs, params)
        state, act = self.logic.reset_spawn(self.generator, self.num_envs)
        state, obs, _r, _d, _info = self._step(state, act, params)
        # the random step does not count against the episode clock
        return state.replace(t=torch.zeros_like(state.t)), obs

    def reset(self, seed: int | None = 0, params: RewardParams | None = None):
        """Seed the env's generator (``seed=None`` goes on with its stream)
        and spawn every env.  Returns (state, obs [E, obs_dim])."""
        params = self.default_params() if params is None else params
        if seed is not None:
            self.generator.manual_seed(int(seed))
        state, obs = self._reset_batch(params)
        return state, obs.T

    def step(self, state: cm.EnvState, action, params: RewardParams | None = None):
        """action: [E, act_dim].  Returns (state, obs [E, obs_dim],
        reward [E], done [E], info dict of [E] tensors).  With auto_reset,
        finished envs come back freshly spawned, with their new obs.

        On a CUDA device this replays the env's CUDA graph of
        :meth:`step_eager` (captured at the first step; a capture that fails
        raises); on the CPU it is :meth:`step_eager`."""
        with span("env.step", step=True):
            params = self.default_params() if params is None else params
            act = torch.as_tensor(action, dtype=torch.float32, device=self.device)
            if self.device.type != "cuda":
                out = self.step_eager(state, act, params)
            else:
                if self._graph is None:
                    self._graph = GraphedStep(weak_call(self.step_eager), self.device,
                                              (self.generator,), self.graph_pool,
                                              name="env.step")
                out = self._graph(state, act, params)
        # tracing on: kernel A's load on the state returned, outside the span
        # and the graph (a no-op with tracing off)
        count_live_pairs(self.logic.layout.table, out[0], self.cfg.dt, site="env.step",
                         every=LIVE_PAIRS_EVERY)
        return out

    def step_eager(self, state: cm.EnvState, action, params: RewardParams | None = None):
        """:meth:`step` as eager PyTorch ops and kernel launches: what the CUDA
        graph captures, what the CPU runs, and what a replay is held against.
        ``params`` may hold Python floats or 0-d float32 tensors."""
        params = self.default_params() if params is None else params
        act = torch.as_tensor(action, dtype=torch.float32, device=self.device).T
        respawn = self.generator if self.fused_respawn else None
        state, obs, reward, done, info = self._step(state, act, params, respawn=respawn)
        if self.auto_reset and respawn is None:
            with device_span("env.autoreset", self.device):
                r_state, r_obs = self._reset_batch(params)
                state = cm.select(done, r_state, state)
                obs = torch.where(done, r_obs, obs)
        return state, obs.T, reward, done, info

    @property
    def fused_respawn(self) -> bool:
        """Whether a step takes its fast autoreset into the env logic's
        kernels (``PuzzleEnvLogic.fused_logic``: v0 and Heavy-v0 on the
        card), which spawn only the envs that end, from uniforms drawn for
        every env as :meth:`_reset_batch` draws them."""
        return (self.auto_reset and self.reset_mode == "fast"
                and self.logic.fused_logic(self.device))

    @functools.cached_property
    def single_observation_space(self):
        return _box_space(self.cfg.obs_dim)

    @functools.cached_property
    def single_action_space(self):
        return _box_space(self.cfg.act_dim, low=-1.0, high=1.0)


@dataclasses.dataclass
class Box:
    """Stand-in for ``gymnasium.spaces.Box`` where gymnasium is missing."""

    low: float
    high: float
    shape: tuple
    dtype: str = "float32"


def _box_space(dim, low=float("-inf"), high=float("inf")):
    """A gymnasium Box of ``dim`` float32 values when gymnasium imports, else
    the :class:`Box` stand-in."""
    try:
        from gymnasium import spaces
    except ImportError:
        return Box(low, high, (dim,))
    return spaces.Box(low=low, high=high, shape=(dim,), dtype=np.float32)
