"""learner_kernels.ppo: the kernel nodes of the learner's CUDA graph (one
update's learner), counted at its capture in set-up, tracing off (the
counter ``profiling.CAPTURES``, record ``ppo.learner``)."""

from portbench import spans


def read(ctx):
    caps = [c for c in spans.setup_captures(ctx) or () if c["name"] == "ppo.learner"
            and not c["traced"]]
    return float(caps[-1]["kernel_nodes"]) if caps else None
