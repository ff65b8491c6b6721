"""render_ms.ppo_pixel: device ms per update in the frames and frame stacks
of the rollout's env steps (the device spans ``env.render`` inside the
rollout's graph), over phase (a) of the traced run (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    ns = spans.per_step(ctx, "device", "env.render")
    return None if ns is None else ns * 1e-6
