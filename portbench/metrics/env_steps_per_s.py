"""env_steps_per_s: env steps x envs completed in the window over its wall
time, from one device synchronize to the next."""

from portbench import yardstick


def read(ctx):
    return yardstick.window_rate(ctx)
