"""Does the TPU's default matmul precision explain the port's lower
``approx_kl``?  The first tenth of the Heavy-v0 H2 recipe (``hv0h2`` in
``torch_h100_ppo_recipes.sh``: 57 updates of 16384 envs x 32 steps,
warm-started from the JAX package's X4 policy file) through the port's
learner, once per matmul mode and training seed, each in a process of its
own, against the JAX run's log (``ppo_hv0_H2_r5.jsonl``, seed 0) over the
same updates:

- ``float32``: the port as it is (TF32 off, ``highest``);
- ``tf32``: ``torch.set_float32_matmul_precision('high')``: cuBLAS rounds the
  operands to TF32 (10 mantissa bits);
- ``bf16``: every ``nn.Linear`` of the MLP (trunk, mean and value heads) with
  its operands rounded to bfloat16 (7 mantissa bits) and the products
  accumulated in float32, forward and backward (the input gradient and the
  weight gradient from the rounded output gradient and rounded operands):
  what XLA's default precision multiplies on a TPU.

Nothing in the port changes: the ``bf16`` mode swaps the forward of the
learner's network modules in this process.  Run from the repo root, on the
card:

    python docs/benchmarks/torch_h100_kl_precision.py [--out FILE]

Prints, per seed and mode, the mean ``approx_kl`` / ``entropy`` /
``ep_rew_mean`` over the updates beside the JAX run's and the port's
committed run at that seed (``torch_h100_hv0h2_s{seed}_leg1.jsonl``), the
ratio to JAX per update (median), then each mode's ratios over the seeds,
and what each ``set_float32_matmul_precision`` setting turns on; one JSON
line per update, seed and mode goes to ``--out`` (by default the committed
record, ``torch_h100_kl_precision.jsonl``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
RECORDS = ROOT / "docs" / "benchmarks"
JAX_LOG = RECORDS / "ppo_hv0_H2_r5.jsonl"
PORT_LOGS = "torch_h100_hv0h2_s{}_leg1.jsonl"
# hv0h2's flags (torch_h100_ppo_recipes.sh) but its seed
FLAGS = ["--env", "MultiRobotPuzzleHeavy-v0", "--n_envs", "16384", "--n_steps", "32",
         "--batch_size", "32768", "--n_epochs", "4", "--learning_rate", "0.00025",
         "--gamma", "0.997", "--clip_range", "0.1", "--ent_coef", "0.001",
         "--set_reward_params", "agentDelta=5,agentDistance=0,blockDelta=2000,blockDistance=0",
         "--max_episode_steps", "1100"]
WARM_START = ROOT / "gym_puzzles_tpu_torch" / "policies" / "MultiRobotPuzzleHeavy-v0_best_r4.npz"
MODES = ("float32", "tf32", "bf16")
SEEDS = (0, 1, 2)  # the training seeds of the committed hv0h2 runs
UPDATES = 57  # the first tenth of H2's 572
KEYS = ("approx_kl", "entropy", "ep_rew_mean", "completions")


def bf16_round(t):
    import torch

    return t.to(torch.bfloat16).to(torch.float32)


def bf16_linear():
    """``F.linear`` with bfloat16-rounded operands and float32 products and
    sums, in both directions (an autograd Function)."""
    import torch
    import torch.nn.functional as F

    class Bf16Linear(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, weight, bias):
            xr, wr = bf16_round(x), bf16_round(weight)
            ctx.save_for_backward(xr, wr)
            return F.linear(xr, wr, bias)

        @staticmethod
        def backward(ctx, grad):
            xr, wr = ctx.saved_tensors
            gr = bf16_round(grad)
            flat_g, flat_x = gr.reshape(-1, gr.shape[-1]), xr.reshape(-1, xr.shape[-1])
            return gr @ wr, flat_g.T @ flat_x, grad.reshape(-1, grad.shape[-1]).sum(0)

    return Bf16Linear.apply


def precision_settings() -> dict:
    """What each ``set_float32_matmul_precision`` value turns on here."""
    import torch

    out = {}
    for value in ("highest", "high", "medium"):
        torch.set_float32_matmul_precision(value)
        out[value] = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                      "cuda.matmul.allow_bf16_reduced_precision_reduction":
                          torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                      "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    torch.set_float32_matmul_precision("highest")
    return out


def run_mode(mode: str, seed: int) -> list[dict]:
    """The first ``UPDATES`` updates of the H2 recipe at ``mode`` and
    training seed ``seed``; one dict per update."""
    import torch
    from torch import nn

    from gym_puzzles_tpu_torch.train import checkpoint as ckpt
    from gym_puzzles_tpu_torch.train import cli
    from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig

    torch.set_float32_matmul_precision("high" if mode == "tf32" else "highest")
    args = cli.build_parser().parse_args(FLAGS + ["--seed", str(seed)])
    cfg = PPOConfig.from_reference_json({}, **cli.overrides_from_args(args))
    learner = PPO(cfg)
    if mode == "bf16":
        linear = bf16_linear()
        for module in learner.net.modules():
            if isinstance(module, nn.Linear):
                module.forward = (lambda m: lambda x: linear(x, m.weight, m.bias))(module)
    state = ckpt.restore_policy(WARM_START, learner.init_state())
    rows, last = [], [time.time()]

    def log_fn(update, metrics):
        now = time.time()
        rows.append({"mode": mode, "seed": seed, "update": update, "timesteps": int(metrics["timesteps"]),
                     "wall_s": now - last[0], **{k: float(metrics[k]) for k in KEYS}})
        last[0] = now

    learner.learn(UPDATES * cfg.n_envs * cfg.n_steps, log_fn=log_fn, state=state)
    return rows


def log_rows(path: Path, n: int) -> list[dict]:
    rows = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith('{"update"')]
    return rows[:n]


def mean(rows, key) -> float:
    v = np.array([r[key] for r in rows], dtype=np.float64)
    return float(np.nanmean(v))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(RECORDS / "torch_h100_kl_precision.jsonl"))
    p.add_argument("--one", default=None, choices=MODES, help=argparse.SUPPRESS)
    p.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:  # a child: one mode at one seed, its rows as JSON lines on stdout
        for row in run_mode(args.one, args.seed):
            print(json.dumps(row), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"set_float32_matmul_precision: {json.dumps(precision_settings())}")
    jax = log_rows(JAX_LOG, UPDATES)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = {}
    with out.open("w") as f:
        for seed in SEEDS:
            for mode in MODES:
                t0 = time.time()
                child = subprocess.run([sys.executable, __file__, "--one", mode,
                                        "--seed", str(seed)],
                                       cwd=ROOT, capture_output=True, text=True)
                if child.returncode:
                    sys.stderr.write(child.stdout + child.stderr)
                    raise SystemExit(f"mode {mode} at seed {seed} failed")
                rows = [json.loads(line) for line in child.stdout.splitlines()
                        if line.startswith("{")]
                runs[seed, mode] = rows
                for row in rows:
                    f.write(json.dumps(row) + "\n")
                print(f"seed {seed} {mode}: {len(rows)} updates in {time.time() - t0:.1f} s "
                      "(process start and capture included)", flush=True)

    def ratio(rows):
        return float(np.median([r["approx_kl"] / j["approx_kl"] for r, j in zip(rows, jax)]))

    print(f"over updates 0-{UPDATES - 1} [{card}]: mean approx_kl / entropy / ep_rew_mean / "
          f"completions; approx_kl against JAX's (seed 0) at the same update (median ratio)")
    print(f"  JAX: " + " / ".join(f"{mean(jax, k):.6g}" for k in KEYS)
          + f"; approx_kl / JAX median {ratio(jax):.4f}")
    for seed in SEEDS:
        port = log_rows(RECORDS / PORT_LOGS.format(seed), UPDATES)
        print(f"  seed {seed}:")
        named = [(f"port's committed seed-{seed} run", port)]
        named += [(mode, runs[seed, mode]) for mode in MODES]
        for name, rows in named:
            print(f"    {name}: " + " / ".join(f"{mean(rows, k):.6g}" for k in KEYS)
                  + f"; approx_kl / JAX median {ratio(rows):.4f}")
        same = [r["approx_kl"] == q["approx_kl"] for r, q in zip(runs[seed, "float32"], port)]
        print(f"    float32 against the committed run: approx_kl equal at {sum(same)} of "
              f"{len(same)} updates")
    print("approx_kl / JAX median per mode over the seeds "
          f"{', '.join(str(s) for s in SEEDS)}:")
    for mode in MODES:
        print(f"  {mode}: " + ", ".join(f"{ratio(runs[s, mode]):.4f}" for s in SEEDS))


if __name__ == "__main__":
    main()
