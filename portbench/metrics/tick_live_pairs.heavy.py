"""tick_live_pairs.heavy: kernel A's load at the rollout, in live pairs per
env: the mean over warps of the most any env of the warp holds (a warp runs
as long as its most loaded env), from the counter ``profiling.LIVE_PAIRS``.
The program takes a record, tracing on, from the state each rollout of
``portbench/spans.py``'s phases ends in, after the update's spans; the
reading is the mean over those records, the only tracing of the run.  None
where the program has no such counter."""

import sys

from portbench import spans


def read(ctx):
    if spans.phases(ctx) is None:
        return None
    from gym_puzzles_tpu_torch.utils import profiling

    recs = getattr(profiling, "LIVE_PAIRS", None)
    if not recs:
        return None
    print("portbench: live pairs per env at each traced rollout's end: "
          + "; ".join(f"mean {r.mean:.3f}, warp max {r.warp_max:.3f}, env max {r.max:.0f}"
                      for r in recs)
          + f" ({recs[0].num_envs} envs, {recs[0].envs_per_warp} per warp, size class "
          f"{recs[0].size_class})", file=sys.stderr)
    return sum(r.warp_max for r in recs) / len(recs)
