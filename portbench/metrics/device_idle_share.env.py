"""device_idle_share.env: the share of the traced window (env steps) in
which no device op ran: 1 - the union of the ops' intervals over the
window's wall time, in %."""

from portbench import yardstick


def read(ctx):
    return yardstick.idle_share(ctx)
