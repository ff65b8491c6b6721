"""render_ms.env: device ms per env step in the frame and the frame stack
(the device span ``env.render`` of the image env), over phase (a) of the
traced run (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    ns = spans.per_step(ctx, "device", "env.render")
    return None if ns is None else ns * 1e-6
