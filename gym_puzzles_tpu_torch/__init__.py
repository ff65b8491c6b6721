"""gym_puzzles_tpu_torch: the PyTorch and CUDA port of gym_puzzles_tpu.

The JAX package ``gym_puzzles_tpu`` stays the reference; this package runs
the same batched multi-robot block-pushing envs on an NVIDIA H100, with the
engine tick in a hand-written CUDA kernel.  It imports neither JAX nor the
JAX package.

Quick start::

    import gym_puzzles_tpu_torch as gpt
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=4096)   # on the card
    state, obs = env.reset(seed=0)
    state, obs, reward, done, info = env.step(state, actions)
"""

__version__ = "0.1.0"

__all__ = ["ENV_IDS", "make", "registry_spec", "__version__"]


def __getattr__(name):
    # Lazy, as in the JAX package: the engine is importable on its own.
    if name in ("ENV_IDS", "make", "registry_spec"):
        from gym_puzzles_tpu_torch.api import registry

        return getattr(registry, name)
    raise AttributeError(name)
