"""tick_kernel_roofline.env: the tick kernel's share of its roofline in the
env steps, in %: the least time of the traced ticks (bytes at the HBM rate
against float32 operations at the float32 peak, counted from the world's
state of each step by ``yardstick.tick_work``) over the traced device time of
the kernels whose names hold one of ``KERNELS``."""

from portbench import yardstick

KERNELS = ("step_fused_kernel",)


def read(ctx):
    return yardstick.tick_roofline(ctx, KERNELS)
