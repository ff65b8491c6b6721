"""Env registry (port of ``gym_puzzles_tpu/api/registry.py``).

    env = make("MultiRobotPuzzle-v0", num_envs=4096)     # on the card
    state, obs = env.reset(seed=0)
    state, obs, reward, done, info = env.step(state, actions)

This slice of the port carries the v0-class ids (MultiRobotPuzzle-v0 and
MultiRobotPuzzleHeavy-v0); the v2 and v3 ids raise ``NotImplementedError``
until their env classes are ported (ROADMAP.md, Queue 1 item 6).
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
           position_iters: int | None = None, max_episode_steps: int | None = None):
    from gym_puzzles_tpu_torch.envs.layout import block_obs_vert_count

    cfg = registry_spec(env_id)
    if cfg.variant != "v0":
        raise NotImplementedError(
            f"{env_id}: the {cfg.variant} env class is not ported to PyTorch yet "
            "(ROADMAP.md, Queue 1 item 6)"
        )
    if max_episode_steps is not None:
        cfg = dataclasses.replace(cfg, max_episode_steps=int(max_episode_steps))
    if velocity_iters is not None:
        cfg = dataclasses.replace(cfg, velocity_iters=int(velocity_iters))
    if position_iters is not None:
        cfg = dataclasses.replace(cfg, position_iters=int(position_iters))
    if block_shape != "t":
        # block-vertex section of the obs: 2 floats per dedup'd vertex
        cfg = dataclasses.replace(
            cfg, block_shape=block_shape,
            obs_dim=cfg.obs_dim + 2 * (block_obs_vert_count(block_shape) - 8),
        )
    from gym_puzzles_tpu_torch.envs.v0 import V0Env

    return V0Env(cfg)


def make(env_id: str, num_envs: int = 1, auto_reset: bool = True,
         reset_mode: str = "fast", backend: str = "fused", block_shape: str = "t",
         velocity_iters: int | None = None, position_iters: int | None = None,
         max_episode_steps: int | None = None, device=None) -> VectorEnv:
    """Build a batched env on ``device`` (default ``cuda``; with no CUDA and
    no device named this raises).

    ``backend='fused'`` -- the only backend of this slice -- runs each engine
    tick in one hand-written CUDA kernel on the card, and the plain PyTorch
    ``world.step`` on the CPU.  ``reset_mode='reference'`` reproduces the
    reference's reset-takes-a-random-step contract (00.py:411).
    ``velocity_iters``/``position_iters`` override the reference's 180/60
    solver iterations; ``max_episode_steps`` the registered episode limit."""
    if backend != "fused":
        raise NotImplementedError(
            f"backend {backend!r} is not ported; the staged solve kernel "
            "('pallas') is ROADMAP.md Queue 2 item B"
        )
    block_shape = _normalize_block_shape(block_shape)
    logic = _logic(env_id, block_shape, velocity_iters, position_iters, max_episode_steps)
    return VectorEnv(logic, num_envs, auto_reset=auto_reset, reset_mode=reset_mode,
                     device=device)
