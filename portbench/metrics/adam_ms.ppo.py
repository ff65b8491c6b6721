"""adam_ms.ppo: device ms per update in the minibatches' optimizer steps
(the device spans ``learn.adam``: clip, Adam, the KL stop's masks and
test), summed over the update, over phase (a) of the traced run
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    ns = spans.per_step(ctx, "device", "learn.adam")
    return None if ns is None else ns * 1e-6
