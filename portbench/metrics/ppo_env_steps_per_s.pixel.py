"""ppo_env_steps_per_s.pixel: n_steps x n_envs of every PPO update run in the
window (rollout and learner) over the wall time from the window's start to
the end of its last update."""

from portbench import yardstick


def read(ctx):
    return yardstick.window_rate(ctx)
