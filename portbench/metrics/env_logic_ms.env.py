"""env_logic_ms.env: device ms per env step in the env's logic around the
tick: the device spans ``env.control``, ``env.score`` and ``env.autoreset``
summed, over phase (a) of the traced run (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    ns = spans.per_step(ctx, "device", "env.control", "env.score", "env.autoreset")
    return None if ns is None else ns * 1e-6
