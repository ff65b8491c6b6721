"""tick_kernel_roofline.ppo: the tick kernel's share of its roofline inside
the rollout's graph, in %: as ``tick_kernel_roofline.env``, with the world's
state at each traced rollout's end standing for that rollout's ticks."""

from portbench import yardstick

KERNELS = ("step_fused_kernel",)


def read(ctx):
    return yardstick.tick_roofline(ctx, KERNELS)
