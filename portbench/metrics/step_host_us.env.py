"""step_host_us.env: host us per env step inside ``env.step`` (the host span
``env.step``: the graph's input copy, its replay's launch and the outputs'
clone), over phase (a) of the traced run, tracing on and the profiler off
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    ns = spans.per_step(ctx, "host", "env.step")
    return None if ns is None else ns * 1e-3
