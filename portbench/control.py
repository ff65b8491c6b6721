"""The readings that a cell's limits are set from: the program's numbers
over many seeds (the lower readings), the control's (the upper), and for
the PPO cells the numbers of planted faults.

    python -m portbench.control --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3]

Each seed runs the cell's set-up and a short window at the cell's own size,
as ``portbench.run`` does, in this one process, and takes the readings that
the cell's loop (``portbench/loops/<kind>.py``, ``READINGS``) gives.  For a
program seed: the program's numbers against the reference, and where the
loop has it the ``twin``, a sound reference with its sums in another order
(the round-off floor).  For a control seed: the reference at the next
precision below the configuration's in the program's place, and the loop's
planted faults.  One JSON line per seed and reading, then the largest sound
reading and the smallest control and fault readings of each number.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import loops
from portbench.run import ROOT, load_cell

SOUND = ("program", "twin")  # readings of sound runs: their largest sets the lower end


def readings(cell: str, seed: int, seconds: float, device, kinds, bench=None,
             root=ROOT) -> dict:
    """{kind: numbers} for one seed, ``kinds`` among the cell's loop's
    ``READINGS``."""
    spec = load_cell(cell, bench, root)
    loop = loops.find(spec["traffic"]["loop"], root)
    out = loop.run(spec["config"], spec["traffic"], seed, seconds, False, torch.device(device),
                   time.perf_counter())
    del out["release"]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return loop.check(out, spec["config"], device, kinds)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 1
    kinds = loops.find(load_cell(a.workload)["traffic"]["loop"]).READINGS
    sound = [k for k in kinds if k in SOUND]
    table: dict = {}
    plan = [(int(s), sound) for s in a.seeds.split(",") if s]
    plan += [(int(s), [k for k in kinds if k not in SOUND]) for s in a.control_seeds.split(",")
             if s]
    for seed, want in plan:
        for kind, nums in readings(a.workload, seed, a.seconds, "cuda", want).items():
            print(json.dumps({"workload": a.workload, "seed": seed, "kind": kind,
                              "numbers": nums}), flush=True)
            for k, v in nums.items():
                if isinstance(v, (int, float)):  # numbers under a leading _ are for the record
                    table.setdefault(kind, {}).setdefault(k, []).append(v)
    summary = {kind: {k: (max(v) if kind in SOUND else min(v)) for k, v in nums.items()}
               for kind, nums in table.items()}
    print(json.dumps({"workload": a.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
