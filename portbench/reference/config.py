"""Per-variant static configuration (port of ``gym_puzzles_tpu/envs/config.py``).

Every magic constant of the reference envs, lifted into frozen dataclasses
(reference: multi_robot_puzzle_00.py:38-88, multi_robot_puzzle_02.py:39-82,
core.py:16-37, robot.py:7-14, blocks.py:11-15).

Mutable-through-methods state of the reference (``set_reward_params``,
``update_params``, ``update_goal``, 00.py:231-246) becomes the
:class:`RewardParams` dataclass passed into every step.  Its fields are
Python floats holding float32-rounded values, so they multiply tensors
exactly as the JAX package's numpy float32 leaves do, and the curriculum
methods do their arithmetic in ``np.float32`` so that their results equal
the JAX package's bit for bit.  The env step also takes a ``RewardParams``
whose fields are 0-d float32 tensors (a CUDA graph's params buffer,
``utils/cuda_graph.py``, as the JAX package traces them as arrays) and
computes the same bits with it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.types import DeviceScalars

# Shared physics rate (00.py:39, 02.py:39, core.py:16)
FPS = 50
DT = 1.0 / FPS
VELOCITY_ITERS = 6 * 30  # world.Step(dt, 6*30, 2*30) everywhere
POSITION_ITERS = 2 * 30

# v0 constants (00.py:38-67)
V0_SCALE = 30.0
V0_VIEWPORT_W, V0_VIEWPORT_H = 640, 480
V0_BORDER = 1.0
V0_FR = 0.999
V0_DAMP = 5.0
V0_DENSE = 5.0
V0_SPEED = 10.0 / V0_SCALE * 4.0  # 4/3 m/s
V0_EPSILON = 25.0
V0_BLOCK_REWARD = 10.0
V0_FINAL_REWARD = 10000.0
V0_AGENT_POLY = np.array(
    [
        (-0.25, -0.75), (0.25, -0.75), (0.75, -0.25), (0.75, 0.25),
        (0.25, 0.75), (-0.25, 0.75), (-0.75, 0.25), (-0.75, -0.25),
    ]
)  # AGENT_POLY with S=2 (00.py:62-67)

# v2 constants (02.py:39-67)
V2_SCALE = 140.0 * 4
V2_VIEWPORT_W, V2_VIEWPORT_H = 1440, 810
V2_BORDER = 0.3
V2_BOUNDS = 0.1
V2_FR = 0.01
V2_LINEAR_DAMP = 5.0
V2_ANG_DAMP = 5.0
V2_BLK_DENSE = 1.56
V2_HEAVY_BLK_DENSE = 20.0  # (02.py:162-165)
V2_AGT_DENSE = 17.3
V2_FORCE = 0.75
V2_EPSILON = 0.1
V2_RATIO = V2_SCALE / V2_VIEWPORT_W
V2_AGENT_POLY = np.array(
    [
        (-0.039, -0.095), (0.039, -0.095), (0.095, -0.039), (0.095, 0.039),
        (0.039, 0.095), (-0.039, 0.095), (-0.095, 0.039), (-0.095, -0.039),
    ]
)

# v3 constants (core.py:16-37, robot.py, blocks.py)
V3_SCALE = 30.0
V3_SCREEN_W, V3_SCREEN_H = 640, 480
V3_BORDER = 1.0
V3_EPSILON = 25.0
V3_BLOCK_FR = 2.5  # blocks.py:12
V3_BLOCK_DAMP = 5.0
V3_AGENT_SCALE = 8.0  # core.py:241
V3_AGENT_DENSITY = 5.0
V3_AGENT_MAX_SPEED = 5.0  # core.py:240
V3_AGENT_FR = 0.2  # robot.py:37-40 sets no friction -> Box2D default
V3_DENSE = 5.0

DEFAULT_FRICTION = 0.2  # Box2D default where the reference sets none


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static env variant description (hashable)."""

    env_id: str
    variant: str  # 'v0' | 'v2' | 'v3'
    num_agents: int
    heavy: bool
    obs_dim: int
    act_dim: int
    max_episode_steps: int
    reward_threshold: float
    frameskip: int = 1
    dt: float = DT
    velocity_iters: int = VELOCITY_ITERS
    position_iters: int = POSITION_ITERS
    # Block shape 't' | 'l' | 'i' (blocks.py:15,80-109; v0 carries the same
    # fixture recipes in its multi-block scaffolding, 00.py:320-351).
    block_shape: str = "t"
    # v2 spawn-branch module constants (02.py:61-62)
    v2_simple: bool = True
    v2_anywhere: bool = False


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(x))


def _ftz(x) -> np.float32:
    """``x`` as float32 with a subnormal flushed to (signed) zero, as XLA on
    the CPU flushes the results of its float32 arithmetic."""
    x = np.float32(x)
    return np.float32(0.0) * np.sign(x) if abs(x) < np.finfo(np.float32).tiny else x


# the base rewards and the shaped copies that update_params derives from them
_SHAPED = (
    ("out_of_bounds_penalty", "shaped_bounds_penalty"),
    ("blk_out_of_bounds_penalty", "shaped_blk_bounds_penalty"),
    ("puzzle_complete_reward", "shaped_puzzle_reward"),
)


@dataclasses.dataclass(frozen=True)
class RewardParams(DeviceScalars):
    """Reward/curriculum parameters.

    Defaults mirror ``set_reward_params`` (00.py:231-239, 02.py:216-225,
    core.py:149-155).  ``shaped_*`` are what the reference's
    ``update_params(timestep, decay)`` computes (02.py:227-230); until it
    runs they equal the bases.  ``scaled_epsilon`` is ``update_goal``'s
    curriculum output (02.py:232-233).
    """

    weight_delta_agent: float
    weight_agent_dist: float
    weight_delta_block: float
    weight_blk_dist: float
    puzzle_complete_reward: float
    out_of_bounds_penalty: float
    blk_out_of_bounds_penalty: float
    shaped_bounds_penalty: float
    shaped_blk_bounds_penalty: float
    shaped_puzzle_reward: float
    scaled_epsilon: float

    @staticmethod
    def default(variant: str) -> "RewardParams":
        if variant == "v0":
            w = dict(agent_delta=10.0, agent_dist=0.1, block_delta=50.0, block_dist=0.025,
                     comp=10000.0, oob=1000.0, blk_oob=100.0, eps=V0_EPSILON)
        elif variant == "v2":
            w = dict(agent_delta=10.0, agent_dist=0.25, block_delta=25.0, block_dist=0.1,
                     comp=10000.0, oob=1000.0, blk_oob=100.0, eps=V2_EPSILON)
        elif variant == "v3":
            w = dict(agent_delta=10.0, agent_dist=0.1, block_delta=50.0, block_dist=0.025,
                     comp=100.0, oob=1000.0, blk_oob=100.0, eps=V3_EPSILON)
        else:
            raise ValueError(variant)
        return RewardParams(
            weight_delta_agent=_f32(w["agent_delta"]),
            weight_agent_dist=_f32(w["agent_dist"]),
            weight_delta_block=_f32(w["block_delta"]),
            weight_blk_dist=_f32(w["block_dist"]),
            puzzle_complete_reward=_f32(w["comp"]),
            out_of_bounds_penalty=_f32(w["oob"]),
            blk_out_of_bounds_penalty=_f32(w["blk_oob"]),
            shaped_bounds_penalty=_f32(w["oob"]),
            shaped_blk_bounds_penalty=_f32(w["blk_oob"]),
            shaped_puzzle_reward=_f32(w["comp"]),
            scaled_epsilon=_f32(w["eps"]),
        )

    # Reference set_reward_params kwarg name -> RewardParams field
    # (00.py:231-239, 02.py:216-225, core.py:149-155).
    REFERENCE_WEIGHT_NAMES = {
        "agentDelta": "weight_delta_agent",
        "agentDistance": "weight_agent_dist",
        "blockDelta": "weight_delta_block",
        "blockDistance": "weight_blk_dist",
        "puzzleComp": "puzzle_complete_reward",
        "outOfBounds": "out_of_bounds_penalty",
        "blkOutOfBounds": "blk_out_of_bounds_penalty",
    }

    def replace(self, **changes) -> "RewardParams":
        return dataclasses.replace(self, **changes)

    def set_reward_params(self, **kw) -> "RewardParams":
        """Reference ``set_reward_params`` (00.py:231-239): override reward
        weights by their reference kwarg names (or field names).  A base
        penalty or reward also resets its ``shaped_*`` copy unless that is
        given too.  An unknown name raises ``TypeError``."""
        fields = {f.name for f in dataclasses.fields(self)}
        repl = {}
        for name, value in kw.items():
            field = self.REFERENCE_WEIGHT_NAMES.get(name, name)
            if field not in fields:
                raise TypeError(f"unknown reward param {name!r}")
            repl[field] = _f32(value)
        for base, shaped in _SHAPED:
            if base in repl and shaped not in repl:
                repl[shaped] = repl[base]
        return self.replace(**repl)

    def update_params(self, timestep, decay) -> "RewardParams":
        """Reference ``update_params`` (00.py:241-243, 02.py:227-230): the
        shaped penalties and reward are the bases scaled by
        ``decay ** (-timestep)``, with ``timestep`` cast to float32."""
        with np.errstate(over="ignore"):  # an overflow is inf, as in JAX
            k = _ftz(np.float32(decay) ** -np.float32(int(timestep)))
        return self.replace(**{shaped: float(_ftz(np.float32(getattr(self, base)) * k))
                               for base, shaped in _SHAPED})

    def update_goal(self, epoch, nb_epochs, base_epsilon) -> "RewardParams":
        """Reference ``update_goal`` (00.py:245-246): the goal epsilon
        shrinks from twice ``base_epsilon`` to ``base_epsilon`` over
        ``nb_epochs``."""
        e = np.float32(epoch) / np.float32(nb_epochs)
        return self.replace(scaled_epsilon=float(np.float32(base_epsilon) * (np.float32(2.0) - e)))


# Registered variants (gym_puzzles/__init__.py:3-36; dims are the empirical
# anchors from SURVEY.md §8.14).
VARIANTS = {
    "MultiRobotPuzzle-v0": EnvConfig(
        env_id="MultiRobotPuzzle-v0", variant="v0", num_agents=2, heavy=False,
        obs_dim=28, act_dim=6, max_episode_steps=2000, reward_threshold=500.0,
    ),
    "MultiRobotPuzzleHeavy-v0": EnvConfig(
        env_id="MultiRobotPuzzleHeavy-v0", variant="v0", num_agents=5, heavy=True,
        obs_dim=40, act_dim=15, max_episode_steps=3000, reward_threshold=500.0,
    ),
    "MultiRobotPuzzle-v2": EnvConfig(
        env_id="MultiRobotPuzzle-v2", variant="v2", num_agents=2, heavy=False,
        obs_dim=39, act_dim=4, max_episode_steps=2000, reward_threshold=500.0,
    ),
    "MultiRobotPuzzleHeavy-v2": EnvConfig(
        env_id="MultiRobotPuzzleHeavy-v2", variant="v2", num_agents=2, heavy=True,
        obs_dim=39, act_dim=4, max_episode_steps=2000, reward_threshold=500.0,
    ),
    "MultiRobotPuzzle-v3": EnvConfig(
        env_id="MultiRobotPuzzle-v3", variant="v3", num_agents=2, heavy=False,
        obs_dim=27, act_dim=6, max_episode_steps=1500, reward_threshold=110.0,
    ),
}
