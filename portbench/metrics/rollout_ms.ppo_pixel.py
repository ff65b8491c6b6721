"""rollout_ms.ppo_pixel: wall ms per update in the rollout (``PPO.rollout``'s
graph replay: policy forward, sampling, normalization, the env step), from
``PhaseTimer``'s ``rollout`` seconds over the traced run's timed updates."""

from portbench import yardstick


def read(ctx):
    return yardstick.phase_ms(ctx, "rollout")
