"""Hyperparameter sweeps (port of ``gym_puzzles_tpu/train/sweep.py``).

The reference tunes with a wandb Bayes sweep over PPO hyperparameters
maximizing rollout/ep_rew_mean (train/sweep-bayes.yml), run as independent
agents on separate machines (README.md:101-107).  This module provides:

* the same search space as a dict (SWEEP_SPACE, mirroring sweep-bayes.yml);
* local random-search runners that train short budgets one after another on
  the local card -- no external service needed;
* ``wandb_sweep_config()`` producing a wandb-compatible sweep dict for
  users who do want wandb agents (`wandb.sweep(wandb_sweep_config())`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import random

# train/sweep-bayes.yml:7-39
SWEEP_SPACE = {
    "learning_rate": {"distribution": "log_uniform", "min": math.log(1e-5), "max": math.log(1e-2)},
    "clip_range": {"values": [0.1, 0.2, 0.3]},
    "batch_size": {"values": [64, 128, 256]},
    "n_epochs": {"values": [5, 10, 20, 50]},
    "ent_coef": {"distribution": "log_uniform", "min": math.log(1e-4), "max": math.log(0.1)},
    "n_steps": {"values": [1024, 2048, 4096]},
    "max_grad_norm": {"values": [0.5, 1.0, 5.0]},
    "vf_coef": {"values": [0.25, 0.5, 1.0]},
    "n_envs": {"values": [4, 6, 8]},
}

METRIC = {"name": "rollout/ep_rew_mean", "goal": "maximize"}


def wandb_sweep_config(program: str = "python -m gym_puzzles_tpu_torch.train.cli"):
    return {"program": program, "method": "bayes", "metric": METRIC,
            "parameters": SWEEP_SPACE}


def sample_params(rng: random.Random) -> dict:
    return _sample_space(rng, SWEEP_SPACE)


# Knobs that live in the TrainState (ppo.HParams) and can change between
# updates of one learner.  Shape-affecting knobs (n_steps, batch_size,
# n_epochs, n_envs) stay fixed per fast sweep, so one PPO (one env batch,
# one network) serves every trial.
DYNAMIC_KNOBS = ("learning_rate", "clip_range", "ent_coef", "vf_coef",
                 "max_grad_norm", "target_kl", "gamma", "gae_lambda")


def _sample_space(rng: random.Random, space: dict) -> dict:
    out = {}
    for name, spec in space.items():
        if "values" in spec:
            out[name] = rng.choice(spec["values"])
        else:
            out[name] = math.exp(rng.uniform(spec["min"], spec["max"]))
    return out


def run_fast_sweep(base_cfg, trials: int = 16, budget_timesteps: int = 10_000_000,
                   seed: int = 0, space: dict | None = None, eval_episodes: int = 0,
                   eval_max_steps: int | None = None, log=print, device=None):
    """Random search over the DYNAMIC knobs only, through one ``PPO``
    reused across every trial: each trial starts from ``init_state(seed *
    7919 + t)`` and sets its sample with ``PPO.set_hparams``.

    ``space`` maps knob -> {"values": [...]} or {"min": log_lo, "max":
    log_hi} (log-uniform); defaults to SWEEP_SPACE restricted to the
    dynamic knobs, and any other knob raises ``ValueError``.  With
    ``eval_episodes > 0`` each trial ends with a deterministic batched
    evaluation (train/evaluate.py, episodes capped at ``eval_max_steps``,
    default the registered limit) and trials are ranked by its mean return
    instead of the length-biased ep_rew_mean.  Runs on ``device`` (default
    ``cuda``; with no CUDA and no device named this raises).

    Returns rows sorted best-first; only ``results[0]["final_state"]``
    carries a TrainState (keeping every trial's state would hold all their
    device memory for the sweep's lifetime).
    """
    from gym_puzzles_tpu_torch.train.ppo import PPO
    import numpy as np

    if space is None:
        space = {k: v for k, v in SWEEP_SPACE.items() if k in DYNAMIC_KNOBS}
    bad = set(space) - set(DYNAMIC_KNOBS)
    if bad:
        raise ValueError(f"not dynamic (needs another learner): {sorted(bad)}")
    algo = PPO(base_cfg, device=device)

    rng = random.Random(seed)
    per_update = base_cfg.n_steps * base_cfg.n_envs
    n_updates = max(1, budget_timesteps // per_update)
    results = []
    # keep only the BEST trial's TrainState: retaining all of them holds
    # trials x (params + Adam moments + n_envs-wide env state) on the card
    best_state, best_score = None, float("-inf")
    for t in range(trials):
        hp = _sample_space(rng, space)
        ts = algo.init_state(seed * 7919 + t)
        ts = algo.set_hparams(ts, **hp)
        rewards, completions = [], 0
        for u in range(n_updates):
            ts = algo.apply_curriculum(ts, u, n_updates)
            ts, m = algo.train_step(ts)
            if np.isfinite(float(m["ep_rew_mean"])):
                rewards.append(float(m["ep_rew_mean"]))
            completions += int(m["completions"])
        tail = rewards[-max(1, len(rewards) // 4):] if rewards else [float("-inf")]
        row = {"trial": t, "score": float(np.mean(tail)),
               "completions": completions, "params": hp}
        if eval_episodes:
            from gym_puzzles_tpu_torch.train.evaluate import evaluate_policy_batched

            ev_mean, ev_std, *_ = evaluate_policy_batched(
                algo, ts, n_episodes=eval_episodes, seed=seed + t, max_steps=eval_max_steps)
            row["eval_mean"] = ev_mean
            row["eval_std"] = ev_std
            row["score"] = ev_mean
        if best_state is None or row["score"] > best_score:
            best_state, best_score = ts, row["score"]
        del ts
        results.append(row)
        log(json.dumps(row))
    results = sorted(results, key=lambda r: -r["score"])
    for r in results:
        r["final_state"] = None
    results[0]["final_state"] = best_state
    return results


def main(argv=None):
    """``python -m gym_puzzles_tpu_torch.train.sweep`` — local sweep runner.

    The reference's sweep story is ``wandb sweep train/sweep-bayes.yml`` +
    agents (README.md:101-107); this is the self-contained equivalent.
    ``--mode fast`` (default) sweeps only the dynamic knobs through one
    learner (run_fast_sweep); ``--mode full`` builds a PPO per trial and
    may sample shape-affecting knobs (run_local_sweep).
    """
    import argparse

    p = argparse.ArgumentParser(description="gym_puzzles_tpu_torch hyperparameter sweep")
    p.add_argument("--config", default=None, type=str, help="JSON config path")
    p.add_argument("--env", default=None, type=str, help="env id override")
    p.add_argument("--mode", choices=["fast", "full"], default="fast")
    p.add_argument("--trials", default=8, type=int)
    p.add_argument("--budget_timesteps", default=10_000_000, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--eval_episodes", default=0, type=int,
                   help="rank fast-sweep trials by honest deterministic "
                        "batched eval instead of ep_rew_mean")
    p.add_argument("--space", default=None, type=str,
                   help='JSON knob spec, e.g. \'{"learning_rate": '
                        '{"min": -9.2, "max": -6.9}, "gamma": '
                        '{"values": [0.99, 0.999]}}\'')
    p.add_argument("--out", default=None, type=str, help="results JSONL path")
    p.add_argument("--update_goal", action="store_true")
    p.add_argument("--update_params_decay", default=None, type=float,
                   help="v2 reward curriculum: per-update env.update_params"
                        "(timestep, decay) decay factor (02.py:227-230)")
    p.add_argument("--env_backend", default=None, choices=["fused", "pallas"])
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default cuda; 'cpu' runs the plain engine)")
    p.add_argument("--velocity_iters", default=None, type=int,
                   help="solver velocity iterations (default: the reference's 180)")
    p.add_argument("--position_iters", default=None, type=int,
                   help="solver position iterations (default: the reference's 60)")
    for name in ("n_envs", "n_steps", "batch_size", "n_epochs"):
        p.add_argument(f"--{name}", default=None, type=int)
    args = p.parse_args(argv)

    rows = []

    def log(line):
        print(line)
        rows.append(line)

    if args.mode == "full":
        # run_local_sweep samples shape knobs itself; flags it cannot honor
        # must fail loudly instead of being silently dropped
        dropped = [flag for flag, val in [
            ("--config", args.config), ("--space", args.space),
            ("--env_backend", args.env_backend), ("--n_steps", args.n_steps),
            ("--batch_size", args.batch_size), ("--n_epochs", args.n_epochs),
            ("--update_goal", args.update_goal),
            ("--update_params_decay", args.update_params_decay),
            ("--eval_episodes", args.eval_episodes),
            ("--velocity_iters", args.velocity_iters),
            ("--position_iters", args.position_iters),
        ] if val]
        if dropped:
            p.error(f"--mode full does not support: {', '.join(dropped)}")
        results = run_local_sweep(
            env_id=args.env or "MultiRobotPuzzle-v0", trials=args.trials,
            budget_timesteps=args.budget_timesteps, seed=args.seed,
            n_envs=args.n_envs, log=log, device=args.device)
    else:
        from gym_puzzles_tpu_torch.train.ppo import PPOConfig

        config = {}
        if args.config:
            with open(args.config) as f:
                config = json.load(f)
        overrides = {"seed": args.seed}
        if args.env:
            overrides["env_id"] = args.env
        if args.update_goal:
            overrides["update_goal"] = True
        if args.update_params_decay is not None:
            overrides["update_params_decay"] = args.update_params_decay
        if args.env_backend:
            overrides["env_backend"] = args.env_backend
        for name in ("n_envs", "n_steps", "batch_size", "n_epochs", "velocity_iters",
                     "position_iters"):
            if getattr(args, name) is not None:
                overrides[name] = getattr(args, name)
        cfg = PPOConfig.from_reference_json(config, **overrides)
        space = json.loads(args.space) if args.space else None
        results = run_fast_sweep(
            cfg, trials=args.trials, budget_timesteps=args.budget_timesteps,
            seed=args.seed, space=space, eval_episodes=args.eval_episodes,
            log=log, device=args.device)

    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(rows) + "\n")
    return results


def run_local_sweep(env_id: str = "MultiRobotPuzzle-v0", trials: int = 8,
                    budget_timesteps: int = 100_000, seed: int = 0,
                    n_envs: int | None = None, log=print, device=None):
    """Sequential random search, a new PPO per trial; returns trials sorted
    by mean episode return over the final quarter of training."""
    from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig
    import numpy as np

    rng = random.Random(seed)
    results = []
    for t in range(trials):
        hp = sample_params(rng)
        if n_envs is not None:
            hp["n_envs"] = n_envs
        cfg = PPOConfig(env_id=env_id, total_timesteps=budget_timesteps,
                        seed=seed + t, **{k: v for k, v in hp.items()
                                          if k in PPOConfig.__dataclass_fields__})
        algo = PPO(cfg, device=device)
        rewards = []

        def log_fn(u, m):
            if np.isfinite(m["ep_rew_mean"]):
                rewards.append(float(m["ep_rew_mean"]))

        algo.learn(log_fn=log_fn)
        tail = rewards[-max(1, len(rewards) // 4):] if rewards else [float("-inf")]
        score = float(np.mean(tail))
        results.append({"trial": t, "score": score, "params": hp})
        log(json.dumps(results[-1]))
    return sorted(results, key=lambda r: -r["score"])


def script_main():
    """Console-script entry: swallow main()'s return so sys.exit(...) is 0."""
    main()


if __name__ == "__main__":
    main()
