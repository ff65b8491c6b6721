"""Summarize the port's runs of the JAX package's recipes on the GPU
(``torch_h100_ppo_recipes.sh`` and ``torch_h100_ppo_v0.sh``; their records
``docs/benchmarks/torch_h100_<run>_*``) against the JAX package's records of
the same recipes.  Run from the repo root (the CPU will do):

    python docs/benchmarks/torch_h100_recipes_report.py [--curves RUN ...]

For each run: the card line, each leg's wall seconds, the trained steps the
eval rows record, the pooled mean return of the 3 x 128 eval episodes against
the band around the JAX records (``chip_smoke.record_band(records, 384)``),
and the whole run's env-steps/s, over the legs' wall time (process start,
kernel build and graph capture included) and over the updates alone (the
trainer's own per-update rates; the first update of each leg includes the
graphs' capture), kernel A's launches in the rollout replays (n_steps per
update, four times that for a pixel recipe's frameskip), each leg's graph
captures where its log records them, the config fields in which each leg
differs from the JAX run's header (the run declares which), update 0's
``ep_rew_mean`` and completions beside the JAX run's (for a warm start, a
check of what it carried), the completions of the eval episodes beside the
JAX records' episodes shorter than the limit, whether the run's final step
count equals the JAX run's modulo 2^32 (the JAX counter is int32), and,
where a run holds one, the mean ``ep_rew_mean`` over a window of updates
beside the JAX run's.  Then one pooled line per recipe run at several
training seeds: the mean ``M`` and standard deviation ``s`` of the runs'
pooled means and the seed-spread rule (the JAX record's mean inside ``M +- 3
s / 2``, three standard errors over the runs; held for Heavy-v2, Heavy-v0
H2 and each leg of the Heavy-v0 curriculum), and the mean over all the
runs' episodes against the band for that many.  ``--curves`` adds, for the runs named, the mean ``ep_rew_mean`` /
``entropy`` / ``approx_kl`` / ``completions`` per tenth of each leg beside
the JAX run's same updates.  A run of more than one leg also prints a line
per leg: its updates, wall time, median update, env-steps/s, launches,
update 0 beside the JAX leg's, and whether update 0 continues the step
count of the leg before it.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from chip_smoke import record_band  # noqa: E402

RECORDS = ROOT / "docs" / "benchmarks"


class Run(NamedTuple):
    records: list  # the JAX records of its recipe's policy (eval rows, one per seed)
    jax_legs: list  # the JAX run's leg logs
    steps: int  # the steps the run trains
    declared: tuple = ()  # config fields the run sets unlike the JAX header
    window: tuple = ()  # updates [lo, hi) whose mean ep_rew_mean the run is held to
    other_records: list = ()  # JAX records of a further band to report beside
    before: str = ""  # the run whose legs come first (its final checkpoint or policy carried on)


HV2 = ([f"eval_hv2_r4_seed{k}_fused.json" for k in range(3)],
       ["ppo_hv2_leg1_r4.jsonl", "ppo_hv2_leg2_r4.jsonl"], 94_633_984)
CNN4 = ([f"eval_v0_cnn_r4_seed{k}.json" for k in range(2)], ["ppo_v0_cnn_r4.jsonl"], 9_994_240)
CNN5 = [f"eval_v0_cnn_r5_seed{k}.json" for k in range(3)]
HV0H2 = ([f"eval_hv0_H2_r5_seed{k}.json" for k in range(3)], ["ppo_hv0_H2_r5.jsonl"],
         1_799_356_416)
RUNS = {
    "v0g": Run([f"eval_v0_r4_seed{k}_fused.json" for k in range(3)],
               ["ppo_v0_leg1_r4.jsonl", "ppo_v0_leg2_r4.jsonl"], 179_830_784),
    "v2": Run([f"eval_v2_r4_seed{k}_fused.json" for k in range(3)],
              ["ppo_v2_leg1_r4.jsonl", "ppo_v2_leg2_r4.jsonl"], 94_633_984),
    "hv2": Run(*HV2),
    "v3": Run([f"eval_v3_r4_seed{k}_fused.json" for k in range(3)],
              ["ppo_v3_retrain_r4.jsonl"], 119_799_808),
    # the Heavy-v2 recipe again at other training seeds
    **{f"hv2_s{k}": Run(*HV2, declared=("seed",)) for k in (4, 5, 6)},
    # the pixel r4 recipe at its own seed and one more
    "cnn4_s17": Run(*CNN4),
    "cnn4_s18": Run(*CNN4, declared=("seed",)),
    # the first 5,126 updates (35-42M steps: the last 854) of the pixel r5
    # recipe's first leg, which has no JAX eval at that point
    "cnn5a": Run(CNN4[0], ["ppo_v0_cnn_r5_leg1.jsonl"], 41_992_192,
                 declared=("total_timesteps",), window=(4272, 5126), other_records=CNN5),
    # the Heavy-v0 endgame: H2 warm-started from the X4 policy at three
    # training seeds (its steps include the warm start's 1,499,463,680), then
    # H3, seed 0's H2 resumed whole at a 1000-step horizon past 2^31 steps
    "hv0h2_s0": Run(*HV0H2),
    **{f"hv0h2_s{k}": Run(*HV0H2, declared=("seed",)) for k in (1, 2)},
    "hv0h3": Run(["eval_hv0_H3_r5_seed0.json"], HV0H2[1] + ["ppo_hv0_H3_r5.jsonl"],
                 2_399_141_888, before="hv0h2_s0"),
}
# Heavy-v0 from a fresh init by the JAX package's whole curriculum (recipe
# hv0c): (leg, the JAX records of its policy, its JAX log, the steps at its
# end); each leg is a run that continues the one before it, H2 by a warm
# start from X4's exported policy
HV0C_LEGS = (
    ("curB", [f"eval_hv0_curB_det_seed{k}.json" for k in range(2)],
     "ppo_hv0_curB_600M_r4.jsonl", 599_785_472),
    ("x2", [f"eval_hv0_X2_seed{k}.json" for k in range(3)], "ppo_hv0_X2_sharpen_r4.jsonl",
     899_678_208),
    ("x3", [f"eval_hv0_X3_seed{k}.json" for k in range(3)], "ppo_hv0_X3_speed_r4.jsonl",
     1_199_570_944),
    ("x4", [f"eval_hv0_X4_seed{k}.json" for k in range(3)], "ppo_hv0_X4_default_r4.jsonl",
     1_499_463_680),
    ("h2", HV0H2[0], HV0H2[1][0], HV0H2[2]),
)


def chain(prefix: str, declared: tuple = ()) -> dict:
    """The runs ``<prefix>_<leg>`` of a chain of the curriculum's legs, each
    with the run of the leg before it as its ``before``."""
    runs, logs, before = {}, [], ""
    for leg, records, log, steps in HV0C_LEGS:
        logs = logs + [log]
        runs[f"{prefix}_{leg}"] = Run(records, logs, steps, declared=declared, before=before)
        before = f"{prefix}_{leg}"
    return runs


RUNS.update(chain("hv0c"))
# the whole chain once more at seeds 111 / 121 / 131 / 141 / 100, as the rule
# fixed before the first chain was read asks when any leg misses its band
RUNS.update(chain("hv0c2", declared=("seed",)))
# and a third time at seeds 211 / 221 / 231 / 241 / 200: with two chains
# M +- 3 s / 2 spans 1.06 times their difference around their midpoint, too
# wide to tell the first chain's misses from a seed's spread
RUNS.update(chain("hv0c3", declared=("seed",)))
# the v0 run of the eager learner, kept under its own names
RUNS["v0 eager"] = RUNS["v0g"]
NAMES = {"v0 eager": ("torch_h100_ppo_v0_leg{}.jsonl", "torch_h100_eval_v0_seed{}.json",
                      "torch_h100_ppo_v0_times.txt")}
# a recipe's runs at several training seeds, pooled, and what each group is
# held to: "spread" = a run that missed its band is a seed's spread if the JAX
# record's mean lies in M +- 3 s / 2, else a port fault; "band" = all the
# runs' episodes inside record_band for that many
SEED_GROUPS = {"hv2": (["hv2", "hv2_s4", "hv2_s5", "hv2_s6"], "spread"),
               "cnn4": (["cnn4_s17", "cnn4_s18"], "band"),
               "hv0h2": (["hv0h2_s0", "hv0h2_s1", "hv0h2_s2"], "spread"),
               # each leg of the three Heavy-v0 curriculum chains
               **{f"hv0c_{leg[0]}": ([f"{c}_{leg[0]}" for c in ("hv0c", "hv0c2", "hv0c3")],
                                     "spread")
                  for leg in HV0C_LEGS}}
CURVE_KEYS = ("ep_rew_mean", "entropy", "approx_kl", "completions")


def paths(run: str) -> tuple:
    """(leg log, eval row, times) of a run's records; the first two take the
    leg or the seed."""
    leg, row, times = NAMES.get(run, (f"torch_h100_{run}_leg{{}}.jsonl",
                                      f"torch_h100_{run}_eval_seed{{}}.json",
                                      f"torch_h100_{run}_times.txt"))
    return ((lambda k: RECORDS / leg.format(k)), (lambda k: RECORDS / row.format(k)),
            RECORDS / times)


def leg_log(run: str, n: int) -> Path:
    """Leg ``n`` (from 1) of a run's trainer logs: the legs of the run it
    continues come first."""
    before = RUNS[run].before
    if before and n <= len(RUNS[before].jax_legs):
        return leg_log(before, n)
    return paths(run)[0](n)


def walls(run: str) -> dict:
    """Wall seconds by command name from a run's times file (its card line
    first), those of the run it continues beneath its own."""
    before = RUNS[run].before
    lines = paths(run)[2].read_text().splitlines()[1:]
    own = {name: float(t) for name, t in (line.split() for line in lines)}
    return {**(walls(before) if before else {}), **own}


def captures(path: Path):
    """The trainer log's graph captures by graph (its ``graph captures:``
    line), or None where the log predates that line."""
    for line in path.read_text().splitlines():
        if line.startswith("graph captures: "):
            return json.loads(line.removeprefix("graph captures: "))
    return None


def updates(path: Path) -> list[dict]:
    """The per-update JSON lines of a trainer's log."""
    rows = []
    for line in path.read_text().splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            if "update" in row:
                rows.append(row)
    return rows


def config(path: Path) -> dict:
    """The fields of a trainer log's ``config: PPOConfig(...)`` line, as text."""
    body = path.read_text().splitlines()[0].removeprefix("config: PPOConfig(")[:-1]
    return dict(re.findall(r"(\w+)=('[^']*'|\([^)]*\)|[^,]+)", body))


def config_diff(run: str) -> list:
    """Per leg, the config fields in which the run differs from the JAX
    run's header (a field the older header lacks counts only when it is not
    None)."""
    out = []
    for k, jax_leg in enumerate(RUNS[run].jax_legs):
        port = config(leg_log(run, k + 1))
        ref = config(RECORDS / jax_leg)
        out.append({f: (ref.get(f), port.get(f)) for f in sorted(set(port) | set(ref))
                    if ref.get(f, "None") != port.get(f)})
    return out


def eval_returns(run: str) -> np.ndarray:
    """The returns of a run's 3 x 128 eval episodes."""
    return np.concatenate([json.loads(paths(run)[1](k).read_text())["returns"]
                           for k in range(3)]).astype(np.float64)


def window_mean(path: Path, window: tuple) -> float:
    """The mean ``ep_rew_mean`` of a log's updates [lo, hi) (NaNs skipped)."""
    rows = [u for u in updates(path) if window[0] <= u["update"] < window[1]]
    return float(np.nanmean(np.array([u["ep_rew_mean"] for u in rows], dtype=np.float64)))


def summary(run: str) -> dict:
    records, jax_legs, steps = RUNS[run][:3]
    row_path, times_path = paths(run)[1:]
    rows = [json.loads(row_path(k).read_text()) for k in range(3)]
    returns = eval_returns(run)
    mean, _sd, _n, band = record_band(records, len(returns))
    wall = walls(run)
    legs = [updates(leg_log(run, k + 1)) for k in range(len(jax_legs))]
    jax_first, jax_last = updates(RECORDS / jax_legs[0])[0], updates(RECORDS / jax_legs[-1])[-1]
    leg_walls = [wall[f"leg{k + 1}"] for k in range(len(legs))]
    per_update = [u for leg in legs for u in leg]
    trained = legs[-1][-1]["timesteps"]
    cfgs = [config(leg_log(run, k + 1)) for k in range(len(legs))]
    # an update's steps over its logged rate: the wall time between two logs
    steps_per = [int(c["n_envs"]) * int(c["n_steps"]) for c in cfgs]
    leg_update_s = [[step / u["steps_per_s"] for u in leg] for leg, step in zip(legs, steps_per)]
    update_s = sum(t for leg in leg_update_s for t in leg)
    # each update replays the rollout's graph, which holds n_steps launches,
    # four per step at the image pipeline's frameskip
    leg_launches = [len(leg) * int(c["n_steps"]) * (4 if c["policy"] == "'cnn'" else 1)
                    for leg, c in zip(legs, cfgs)]
    stepped = sum(len(leg) * step for leg, step in zip(legs, steps_per))
    jax_logs = [updates(RECORDS / f) for f in jax_legs]
    jax_lengths = np.concatenate([json.loads((RECORDS / f).read_text())["lengths"]
                                  for f in records])
    window = RUNS[run].window
    held = window and (window_mean(leg_log(run, 1), window),
                       window_mean(RECORDS / jax_legs[0], window))
    other = RUNS[run].other_records
    return dict(card=times_path.read_text().splitlines()[0], leg_walls=leg_walls,
                eval_walls=[wall[f"eval_seed{k}"] for k in range(3)],
                trained=[r["trained_timesteps"] for r in rows], logged_steps=trained,
                steps_ok=trained == steps and all(r["trained_timesteps"] == steps for r in rows),
                jax_steps=jax_last["timesteps"],
                wraps=(trained - jax_last["timesteps"]) % 2**32 == 0,
                first=(legs[0][0]["ep_rew_mean"], legs[0][0]["completions"]),
                jax_first=(jax_first["ep_rew_mean"], jax_first["completions"]),
                jax_completions=int((jax_lengths < rows[0]["max_steps"]).sum()),
                jax_episodes=len(jax_lengths),
                captures=[captures(leg_log(run, k + 1)) for k in range(len(legs))],
                pooled=float(returns.mean()), jax_mean=mean, band=band,
                inside=band[0] <= returns.mean() <= band[1],
                seed_means=[r["mean_return"] for r in rows],
                completions=[r["completions"] for r in rows],
                updates=len(per_update), run_rate=stepped / sum(leg_walls),
                launches=sum(leg_launches), update_rate=stepped / update_s,
                first_s=[leg[0] for leg in leg_update_s],
                median_s=float(np.median([t for leg in leg_update_s for t in leg[1:]])),
                start_s=[w - sum(leg) for w, leg in zip(leg_walls, leg_update_s)],
                eval_iters=[r["eval_solver_iters"] for r in rows], window=window, held=held,
                other_band=other and record_band(other, len(returns)),
                # per leg: updates, median s per update past the first,
                # env-steps/s over its wall time and over the updates,
                # launches, update 0's ep_rew_mean and completions beside the
                # JAX leg's, and whether update 0 continues the step count of
                # the leg before it
                legs=[dict(updates=len(leg), wall=w, median_s=float(np.median(t[1:] or t)),
                           wall_rate=len(leg) * step / w, update_rate=len(leg) * step / sum(t),
                           launches=n,
                           first=(leg[0]["ep_rew_mean"], leg[0]["completions"]),
                           jax_first=(ref[0]["ep_rew_mean"], ref[0]["completions"]),
                           continues=k == 0 or leg[0]["timesteps"]
                           == legs[k - 1][-1]["timesteps"] + step)
                      for k, (leg, w, t, step, n, ref) in enumerate(
                          zip(legs, leg_walls, leg_update_s, steps_per, leg_launches, jax_logs))])


def seed_pool(group: str) -> dict:
    """A recipe's runs at several training seeds: each run's pooled mean,
    the runs whose mean missed its own band, their mean ``M`` and sample
    standard deviation ``s``, whether the JAX record's mean lies in ``M +- 3
    s / 2`` (the rule that tells a miss a seed's spread or a port fault), and
    the mean of all the runs' episodes against the band for that many."""
    runs, held = SEED_GROUPS[group]
    means = np.array([eval_returns(r).mean() for r in runs])
    bands = [record_band(RUNS[r].records, len(eval_returns(r)))[3] for r in runs]
    missed = [r for r, m, (lo, hi) in zip(runs, means, bands) if not lo <= m <= hi]
    every = np.concatenate([eval_returns(r) for r in runs])
    jax_mean, _sd, _n, band = record_band(RUNS[runs[0]].records, len(every))
    m, sd = float(means.mean()), float(means.std(ddof=1))
    return dict(runs=runs, held=held, means=means.tolist(), missed=missed, M=m, s=sd,
                jax_mean=jax_mean,
                spread=(m - 1.5 * sd, m + 1.5 * sd), within=abs(jax_mean - m) <= 1.5 * sd,
                episodes=len(every), pooled=float(every.mean()), band=band,
                inside=band[0] <= every.mean() <= band[1])


def curves(run: str, parts: int = 10):
    jax_legs = RUNS[run].jax_legs
    for k, jax_leg in enumerate(jax_legs):
        port = updates(leg_log(run, k + 1))
        ref = updates(RECORDS / jax_leg)
        n = len(port)
        print(f"\n{run} leg {k + 1} ({n} updates; JAX {len(ref)}): mean per tenth, port | "
              "JAX over the same updates")
        print("| updates | " + " | ".join(CURVE_KEYS) + " |")
        print("|---|" + "---|" * len(CURVE_KEYS))
        for lo in range(0, n, -(-n // parts)):
            hi = min(n, lo - (-n // parts))

            def avg(rows, key):
                v = np.array([r[key] for r in rows[lo:hi]], dtype=np.float64)
                return float(np.nanmean(v)) if np.isfinite(v).any() else float("nan")

            cells = [f"{avg(port, key):,.4g} \\| {avg(ref, key):,.4g}" for key in CURVE_KEYS]
            print(f"| {lo}-{hi - 1} | " + " | ".join(cells) + " |")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--curves", nargs="*", default=[], choices=list(RUNS))
    args = p.parse_args(argv)
    for run in RUNS:
        if not paths(run)[2].exists():
            print(f"{run}: no records")
            continue
        s = summary(run)
        print(f"{run}: [{s['card']}] legs {', '.join(f'{w:.1f}' for w in s['leg_walls'])} s, "
              f"evals {', '.join(f'{w:.1f}' for w in s['eval_walls'])} s; {s['updates']} updates, "
              f"{s['logged_steps']:,} steps (eval rows {s['trained']}: "
              f"{'' if s['steps_ok'] else 'NOT '}as the recipe says); pooled mean "
              f"{s['pooled']:,.1f} (seeds {', '.join(f'{m:,.1f}' for m in s['seed_means'])}; "
              f"completions {s['completions']}, the JAX records' episodes shorter than "
              f"the limit {s['jax_completions']} / {s['jax_episodes']}) against the band "
              f"[{s['band'][0]:,.1f}, {s['band'][1]:,.1f}] around {s['jax_mean']:,.1f}: "
              f"{'inside' if s['inside'] else 'OUTSIDE'}; env-steps/s {s['run_rate']:,.0f} over "
              f"the legs' wall time, {s['update_rate']:,.0f} over the updates; kernel-A "
              f"launches in the rollout replays {s['launches']:,}; an update past the first "
              f"of its leg {s['median_s']:.4f} s (median), the first "
              f"{', '.join(f'{t:.2f}' for t in s['first_s'])} s, each leg's time outside its "
              f"updates {', '.join(f'{t:.1f}' for t in s['start_s'])} s; graph captures per "
              f"leg {s['captures']}; update 0 ep_rew_mean {s['first'][0]:,.1f}, completions "
              f"{s['first'][1]} (JAX {s['jax_first'][0]:,.1f}, {s['jax_first'][1]}); final steps "
              f"{'equal to' if s['wraps'] else 'NOT equal to'} the JAX run's {s['jax_steps']:,} "
              f"modulo 2^32; config fields "
              f"unlike the JAX run's, per leg: {config_diff(run)} (declared "
              f"{list(RUNS[run].declared)}); eval solver iterations {s['eval_iters']}")
        if len(s["legs"]) > 1:
            for k, leg in enumerate(s["legs"]):
                print(f"  {run} leg {k + 1}: {leg['updates']} updates in {leg['wall']:.1f} s, "
                      f"{leg['median_s']:.4f} s per update (median past the first), env-steps/s "
                      f"{leg['wall_rate']:,.0f} over its wall time and {leg['update_rate']:,.0f} "
                      "over the updates, kernel-A launches "
                      f"{leg['launches']:,}; update 0 ep_rew_mean {leg['first'][0]:,.1f}, "
                      f"completions {leg['first'][1]} (JAX {leg['jax_first'][0]:,.1f}, "
                      f"{leg['jax_first'][1]})"
                      + ("" if k == 0 else f"; its step count "
                         f"{'continues' if leg['continues'] else 'does NOT continue'} "
                         "the leg before it"))
        if s["window"]:
            lo, hi = s["window"]
            print(f"  {run}: mean ep_rew_mean over updates {lo}-{hi - 1} {s['held'][0]:,.1f} "
                  f"(JAX {s['held'][1]:,.1f}): {'above' if s['held'][0] > 0 else 'NOT above'} 0")
        if s["other_band"]:
            o = s["other_band"]
            print(f"  {run}: beside the band of {RUNS[run].other_records}, "
                  f"[{o[3][0]:,.1f}, {o[3][1]:,.1f}] around {o[0]:,.1f}")
    for group in SEED_GROUPS:
        if not all(paths(run)[2].exists() for run in SEED_GROUPS[group][0]):
            print(f"{group}: no records of every run")
            continue
        g = seed_pool(group)
        spread = (f"the JAX mean {g['jax_mean']:,.1f} "
                  f"{'inside' if g['within'] else 'OUTSIDE'} M +- 3 s / 2 = "
                  f"[{g['spread'][0]:,.1f}, {g['spread'][1]:,.1f}]")
        if g["held"] == "spread" and g["missed"]:
            spread += (f" ({', '.join(g['missed'])} missed: "
                       + ("a seed's spread)" if g["within"] else "a port fault)"))
        elif g["held"] == "spread":
            spread += " (no run missed its band: the rule is not applied)"
        print(f"{group} over {len(g['runs'])} training seeds ({', '.join(g['runs'])}): pooled "
              f"means {', '.join(f'{m:,.1f}' for m in g['means'])}; M {g['M']:,.1f}, s "
              f"{g['s']:,.1f}; {spread}; all {g['episodes']} episodes {g['pooled']:,.1f} "
              f"against [{g['band'][0]:,.1f}, {g['band'][1]:,.1f}]: "
              f"{'inside' if g['inside'] else 'OUTSIDE'}")
    for run in args.curves:
        curves(run)


if __name__ == "__main__":
    main()
