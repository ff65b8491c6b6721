"""Env registry (port of ``gym_puzzles_tpu/api/registry.py``).

    env = make("MultiRobotPuzzle-v0", num_envs=4096)     # on the card
    state, obs = env.reset(seed=0)
    state, obs, reward, done, info = env.step(state, actions)

All five registered ids are carried: MultiRobotPuzzle-v0,
MultiRobotPuzzleHeavy-v0, MultiRobotPuzzle-v2, MultiRobotPuzzleHeavy-v2 and
MultiRobotPuzzle-v3.
"""

from __future__ import annotations

import dataclasses
import functools
import random
import warnings

from gym_puzzles_tpu_torch.api.vector import VectorEnv
from gym_puzzles_tpu_torch.envs.config import VARIANTS, EnvConfig

ENV_IDS = tuple(VARIANTS)


def registry_spec(env_id: str) -> EnvConfig:
    """Static spec (obs/act dims, step limit, reward threshold)."""
    try:
        return VARIANTS[env_id]
    except KeyError:
        raise KeyError(f"unknown env id {env_id!r}; known: {list(ENV_IDS)}") from None


def _normalize_block_shape(shape: str) -> str:
    """The reference Block entity's shape validation: case-insensitive, and
    an unsupported name warns + picks a shape at random (blocks.py:41-45)."""
    if isinstance(shape, str):
        shape = shape.lower()
    if shape not in ("t", "l", "i"):
        warnings.warn(
            f"WARN: Block shape {shape} is not supported. Choose between "
            "[T, L, I]. Choosing shape at random"
        )
        shape = random.choice(["t", "l", "i"])
    return shape


@functools.lru_cache(maxsize=None)
def _logic(env_id: str, block_shape: str = "t", velocity_iters: int | None = None,
           position_iters: int | None = None, max_episode_steps: int | None = None,
           num_agents: int | None = None, heavy: bool | None = None,
           simple: bool | None = None, anywhere: bool | None = None):
    from gym_puzzles_tpu_torch.envs.layout import block_obs_vert_count

    cfg = registry_spec(env_id)
    if max_episode_steps is not None:
        cfg = dataclasses.replace(cfg, max_episode_steps=int(max_episode_steps))
    if velocity_iters is not None:
        cfg = dataclasses.replace(cfg, velocity_iters=int(velocity_iters))
    if position_iters is not None:
        cfg = dataclasses.replace(cfg, position_iters=int(position_iters))
    if simple is not None or anywhere is not None:
        # SIMPLE/ANYWHERE are module constants of the v2 file only
        # (02.py:61-62); the other variants have no such branches.
        if cfg.variant != "v2":
            raise ValueError(
                "simple/anywhere are v2 spawn-branch capabilities "
                "(multi_robot_puzzle_02.py:61-62); v0/v3 have none"
            )
        cfg = dataclasses.replace(
            cfg,
            v2_simple=cfg.v2_simple if simple is None else bool(simple),
            v2_anywhere=cfg.v2_anywhere if anywhere is None else bool(anywhere),
        )
    if num_agents is not None or heavy is not None:
        # The reference's constructor surface: only RobotPuzzleBase (v3) takes
        # world-shape kwargs (core.py:86-93); v0/v2 classes take none.
        if cfg.variant != "v3":
            raise ValueError(
                "num_agents/heavy are v3 constructor capabilities "
                "(RobotPuzzleBase, core.py:86-93); v0/v2 have fixed worlds"
            )
        A = cfg.num_agents if num_agents is None else int(num_agents)
        if A < 1:
            raise ValueError(f"num_agents must be >= 1, got {A}")
        cfg = dataclasses.replace(
            cfg,
            num_agents=A,
            heavy=cfg.heavy if heavy is None else bool(heavy),
            # obs: 4 per agent + 3 block + 16 verts (core.py:120-133);
            # act: 3 per agent (core.py:135-136).
            obs_dim=4 * A + 3 + 16,
            act_dim=3 * A,
        )
    if block_shape != "t":
        if cfg.variant == "v2":
            raise ValueError(
                "block_shape is a v0/v3 capability (the reference v2 builds "
                "its T block inline, 02.py:322-341)"
            )
        # block-vertex section of the obs: 2 floats per dedup'd vertex
        cfg = dataclasses.replace(
            cfg, block_shape=block_shape,
            obs_dim=cfg.obs_dim + 2 * (block_obs_vert_count(block_shape) - 8),
        )
    if cfg.variant == "v0":
        from gym_puzzles_tpu_torch.envs.v0 import V0Env

        return V0Env(cfg)
    if cfg.variant == "v2":
        from gym_puzzles_tpu_torch.envs.v2 import V2Env

        return V2Env(cfg)
    from gym_puzzles_tpu_torch.envs.v3 import V3Env

    return V3Env(cfg)


@functools.lru_cache(maxsize=None)
def _image_logic(env_id: str, frameskip: int = 4, block_shape: str = "t",
                 velocity_iters: int | None = None, position_iters: int | None = None):
    """Env logic at the reference's image-mode physics config (frameskip 4,
    00.py:161-162) for the pixel-observation pipeline: ``frameskip`` engine
    ticks per env step, the first with the step's controls."""
    base = _logic(env_id, block_shape, velocity_iters, position_iters)
    if frameskip == base.cfg.frameskip:
        return base
    return type(base)(dataclasses.replace(base.cfg, frameskip=int(frameskip)))


def make(env_id: str, num_envs: int = 1, auto_reset: bool = True,
         reset_mode: str = "fast", backend: str = "fused", block_shape: str = "t",
         num_agents: int | None = None, heavy: bool | None = None,
         goal_velocity: float | None = None, block_density: float | None = None,
         hardmode: bool | None = None, simple: bool | None = None,
         anywhere: bool | None = None, velocity_iters: int | None = None,
         position_iters: int | None = None, max_episode_steps: int | None = None,
         device=None) -> VectorEnv:
    """Build a batched env on ``device`` (default ``cuda``; with no CUDA and
    no device named this raises).

    ``backend='fused'`` (default) runs each engine tick in one launch of the
    hand-written fused CUDA kernel.  ``backend='pallas'`` keeps the JAX
    package's name for the staged tick; in the port it means the PyTorch
    narrow phase, islands and sleep bookkeeping around one launch of the
    hand-written CUDA contact-solve kernel.  On the CPU both run the plain
    PyTorch engine.  Any other name raises ``ValueError``.

    ``reset_mode='reference'`` reproduces the reference's
    reset-takes-a-random-step contract (00.py:411).  ``block_shape`` selects
    the block geometry 't'|'l'|'i' (v0 and v3).  ``num_agents``/``heavy``
    are v3's constructor surface (core.py:86-93): obs dim becomes 4A+3+16,
    act dim 3A, and ``heavy`` scales the T block; a world beyond the CUDA
    kernels' table sizes raises ``ValueError`` at the first step on the card.
    ``simple``/``anywhere`` (v2 only) select that file's spawn branches
    (02.py:61-62).  ``goal_velocity``, ``block_density`` and ``hardmode``
    are accepted and ignored, exactly like the reference, where they are
    stored but never read (SURVEY quirk #12).
    ``velocity_iters``/``position_iters`` override the reference's 180/60
    solver iterations; ``max_episode_steps`` the registered episode limit."""
    del goal_velocity, block_density, hardmode  # quirk #12: dead in the reference too
    block_shape = _normalize_block_shape(block_shape)
    logic = _logic(env_id, block_shape, velocity_iters, position_iters, max_episode_steps,
                   num_agents, heavy, simple, anywhere)
    return VectorEnv(logic, num_envs, auto_reset=auto_reset, reset_mode=reset_mode,
                     device=device, backend=backend)
