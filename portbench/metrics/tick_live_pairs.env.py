"""tick_live_pairs.env: kernel A's load in the env steps, in live pairs per
env: the mean over warps of the most any env of the warp holds (a warp runs
as long as its most loaded env), from the counter ``profiling.LIVE_PAIRS``.
With tracing on the program takes a record of every 25th state that
``VectorEnv.step`` returns in a tracing block (site ``env.step``), after the
step's span; of ``portbench/spans.py``'s phases only (a), whose steps are
the loop's traced steps (100), is that long.  The reading is the mean over
the env step's records.  None where the program has no such records."""

import sys

from portbench import spans

SITE = "env.step"


def read(ctx):
    if spans.phases(ctx) is None:
        return None
    from gym_puzzles_tpu_torch.utils import profiling

    recs = [r for r in getattr(profiling, "LIVE_PAIRS", []) if getattr(r, "site", None) == SITE]
    if not recs:
        return None
    print("portbench: live pairs per env at the traced env steps' records: "
          + "; ".join(f"mean {r.mean:.3f}, warp max {r.warp_max:.3f}, env max {r.max:.0f}"
                      for r in recs)
          + f" ({recs[0].num_envs} envs, {recs[0].envs_per_warp} per warp, size class "
          f"{recs[0].size_class})", file=sys.stderr)
    return sum(r.warp_max for r in recs) / len(recs)
