"""capture_s: seconds of set-up in the CUDA graphs' warm-ups and captures
(the counter ``profiling.CAPTURES``, read before ``portbench/spans.py``'s
phases: the set-up's captures, tracing off; the window captures none), a
part of ``setup_s``."""

from portbench import spans


def read(ctx):
    caps = spans.setup_captures(ctx)
    return sum(c["seconds"] for c in caps) if caps else None
