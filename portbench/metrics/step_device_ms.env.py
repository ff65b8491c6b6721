"""step_device_ms.env: device ms per env step, the sum of the device ops'
times in the trace over the traced steps (``profile_step.trace``'s
arithmetic)."""

from portbench import yardstick


def read(ctx):
    return yardstick.device_ms_per_step(ctx)
