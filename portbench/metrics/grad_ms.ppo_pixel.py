"""grad_ms.ppo_pixel: device ms per update in the minibatches' gradients (the
device spans ``learn.grad``: gather, forward, loss, backward), summed over
the update, over phase (a) of the traced run (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    ns = spans.per_step(ctx, "device", "learn.grad")
    return None if ns is None else ns * 1e-6
