"""update_host_ms.ppo: host ms per update inside ``PPO.train_step`` (the host
span ``ppo.update``: the noise, both graphs' copies and launches, the
generator's state), over phase (a) of the traced run, tracing on and the
profiler off (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    ns = spans.per_step(ctx, "host", "ppo.update")
    return None if ns is None else ns * 1e-6
