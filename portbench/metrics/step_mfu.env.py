"""step_mfu.env: the whole env step's share of the card's peak, in %: the
tick's least time (``yardstick.tick_least_time``, the only counted work of a
step; the env's elementwise ops and the frame are not counted) over the
traced window's wall time.  It bounds ``tick_kernel_roofline.env``: a step
made faster anywhere raises it."""

from portbench import yardstick


def read(ctx):
    least = yardstick.tick_least_time(ctx)
    if least is None or not ctx.get("window_s"):
        return None
    return 100.0 * least / ctx["window_s"]
