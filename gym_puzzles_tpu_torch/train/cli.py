"""Training CLI (port of ``gym_puzzles_tpu/train/cli.py``), reference-compatible.

Mirrors train/train.py + train/parsers.py: a JSON config file (the
reference's train/configs/*.json load unchanged), CLI overrides for seed /
timesteps / n_envs and the PPO hyperparameters, optional wandb logging, and
checkpoint save/resume.  Runs on the card unless ``--device`` names another:

    python -m gym_puzzles_tpu_torch.train.cli --config train_configs/ppo-mrp-v0.json \\
        --n_envs 4096 --n_steps 64 --batch_size 8192 --n_epochs 4 \\
        --total_timesteps 5000000

``--policy cnn`` trains the NatureCNN policy on v0's device-rendered
frames (the JAX package's image pipeline: 3 stacked frames, frameskip 4,
downsample 4).  ``--distributed`` trains a ``DistributedPPO`` over
torchrun's processes, one per GPU (``parallel/mesh.py``), each with
``n_envs / N`` envs; only rank 0 prints and logs, and checkpoints hold the
replicated state once and each rank's shard:

    torchrun --nproc_per_node N -m gym_puzzles_tpu_torch.train.cli --distributed \
        --config train_configs/ppo-mrp-v0.json --n_envs 4096 ...

Without torchrun's variables ``--distributed`` runs at world size 1.
"""

from __future__ import annotations

import argparse
import json
import time

HPARAM_FLAGS = (("learning_rate", float), ("clip_range", float), ("batch_size", int),
                ("n_epochs", int), ("ent_coef", float), ("n_steps", int),
                ("max_grad_norm", float), ("vf_coef", float), ("gamma", float),
                ("gae_lambda", float), ("target_kl", float))


def build_parser():
    p = argparse.ArgumentParser(description="PPO on gym_puzzles_tpu_torch")
    # base flags (parsers.py:22-75)
    p.add_argument("--config", default=None, type=str, help="JSON config path")
    p.add_argument("--env", default=None, type=str, help="env id override")
    p.add_argument("--seed", default=17, type=int)
    p.add_argument("--total_timesteps", default=1_000_000, type=int)
    p.add_argument("--n_envs", default=None, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default cuda, which must exist; 'cpu' runs the "
                        "plain engine)")
    p.add_argument("--disable_wandb", action="store_true")
    p.add_argument("--run_wandb_sweep", action="store_true",
                   help="third config tier (parsers.py:61-66, train.py:33-41): "
                        "a wandb sweep agent's wandb.config values override the JSON "
                        "config and CLI flags")
    p.add_argument("--save_model", action="store_true")
    p.add_argument("--checkpoint_dir", default="models", type=str)
    p.add_argument("--checkpoint_every", default=0, type=int,
                   help="also checkpoint every N updates (0 = at the end only)")
    p.add_argument("--resume", default=None, type=str,
                   help="checkpoint directory to resume (the whole TrainState; under "
                        "--distributed, one written at the same world size)")
    p.add_argument("--resume_policy", default=None, type=str,
                   help="warm start from a policy: a checkpoint directory or a policy "
                        ".npz (train/export.py); params and normalizer moments graft "
                        "into a fresh TrainState of any n_envs")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel over torchrun's processes (one per GPU, cuda:LOCAL_RANK "
                        "unless --device names one; NCCL, or gloo on the CPU): each rank "
                        "steps n_envs / WORLD_SIZE envs")
    p.add_argument("--update_params_decay", default=None, type=float,
                   help="per-update reward decay (the reference's "
                        "env.update_params(timestep, decay) hook)")
    p.add_argument("--anneal_lr", action="store_true", help="linear lr decay over the run")
    p.add_argument("--update_goal", action="store_true",
                   help="shrink the goal epsilon over training (the reference's "
                        "env.update_goal(epoch, nb_epochs))")
    p.add_argument("--set_reward_params", default=None, type=str,
                   help="reward-weight overrides by the reference's set_reward_params "
                        "kwarg names (00.py:231-239), e.g. "
                        "'agentDelta=30,blockDelta=400,blockDistance=0.005'")
    p.add_argument("--reward_anneal_updates", default=None, type=int,
                   help="linearly anneal --set_reward_params overrides back to the "
                        "variant defaults over the first N updates")
    p.add_argument("--policy", default=None, choices=["mlp", "cnn"],
                   help="mlp (flat obs, default) or cnn (the v0 image-obs mode, "
                        "00.py:161-162,197-200: NatureCNN on stacked frames rendered "
                        "on the device)")
    p.add_argument("--env_backend", default=None, choices=["fused", "pallas"],
                   help="engine tick: fused = one launch of the fused tick kernel per "
                        "step (default), pallas = the staged tick around the "
                        "contact-solve kernel")
    p.add_argument("--velocity_iters", default=None, type=int,
                   help="solver velocity iterations (default: the reference's 180)")
    p.add_argument("--position_iters", default=None, type=int,
                   help="solver position iterations (default: the reference's 60)")
    p.add_argument("--max_episode_steps", default=None, type=int,
                   help="training-horizon override; evaluation keeps the registered limit")
    p.add_argument("--log_interval", default=1, type=int)
    # PPO hparams (parsers.py:78-131)
    for name, typ in HPARAM_FLAGS:
        p.add_argument(f"--{name}", default=None, type=typ)
    return p


def overrides_from_args(args) -> dict:
    """PPOConfig overrides from the parsed flags."""
    overrides = {k: getattr(args, k) for k, _ in HPARAM_FLAGS if getattr(args, k) is not None}
    for flag, field in (("env", "env_id"), ("n_envs", "n_envs"), ("policy", "policy"),
                        ("env_backend", "env_backend"),
                        ("velocity_iters", "velocity_iters"),
                        ("position_iters", "position_iters"),
                        ("max_episode_steps", "max_episode_steps"),
                        ("update_params_decay", "update_params_decay"),
                        ("reward_anneal_updates", "reward_anneal_updates")):
        if getattr(args, flag) is not None:
            overrides[field] = getattr(args, flag)
    if args.update_goal:
        overrides["update_goal"] = True
    if args.anneal_lr:
        overrides["anneal_lr"] = True
    if args.set_reward_params:
        overrides["reward_params"] = tuple(
            (k.strip(), float(v))
            for k, v in (item.split("=") for item in args.set_reward_params.split(",") if item))
    overrides["seed"] = args.seed
    overrides["total_timesteps"] = args.total_timesteps
    return overrides


def leg_overrides(learner, state):
    """A restored TrainState made ready for this run (``--resume``, as the
    JAX CLI does it): this run's hyperparameters (the learner's config:
    ``ent_coef``, ``learning_rate``, ``gamma`` in the normalizer too, ...)
    and reward params (the learner's, so that a curriculum restarts over this
    run's updates) replace the checkpoint's; its params, Adam state,
    normalizer moments, env batch and generators carry over."""
    from gym_puzzles_tpu_torch.train.ppo import HParams

    hparams = HParams.from_config(learner.cfg)
    return state.replace(hparams=hparams, env_params=learner.env_params,
                         normalizer=state.normalizer.replace(gamma=hparams.gamma))


def main(argv=None):
    from gym_puzzles_tpu_torch.train import checkpoint as ckpt
    from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig

    args = build_parser().parse_args(argv)
    config = {}
    if args.config:
        with open(args.config) as f:
            config = json.load(f)
    overrides = overrides_from_args(args)

    mesh = None
    if args.distributed:
        from gym_puzzles_tpu_torch.parallel import DistributedPPO, init_distributed, make_mesh

        init_distributed(device=args.device)
        mesh = make_mesh()
        if args.run_wandb_sweep and mesh.world_size > 1:
            # the sweep's config would reach rank 0 alone
            raise SystemExit("--run_wandb_sweep needs a single rank")
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)

    logger = None
    if lead and not args.disable_wandb:
        try:
            import wandb

            project = overrides.get("env_id") or config.get("env", "MultiRobotPuzzle-v0")
            logger = wandb.init(project=project, group="PPO-torch-v1", config=vars(args))
            if args.run_wandb_sweep:
                # a sweep agent's wandb.config wins over JSON + CLI (train.py:33-41)
                import dataclasses

                fields = {f.name for f in dataclasses.fields(PPOConfig)}
                sweep_cfg = {k: v for k, v in dict(wandb.config).items() if k in fields}
                if "net_arch" in sweep_cfg:
                    sweep_cfg["net_arch"] = tuple(sweep_cfg["net_arch"])
                overrides.update(sweep_cfg)
        except Exception as e:  # wandb is optional: log to stdout without it
            print(f"wandb unavailable ({e}); logging to stdout only")
    elif args.run_wandb_sweep:
        say("--run_wandb_sweep ignored: wandb disabled")

    cfg = PPOConfig.from_reference_json(config, **overrides)
    say(f"config: {cfg}")
    if mesh is None:
        algo = learner = PPO(cfg, device=args.device)
    else:
        algo = DistributedPPO(cfg, device=args.device)
        learner = algo.ppo
        say(f"distributed: {mesh.world_size} rank(s), {mesh.backend or 'no'} process group, "
            f"{learner.cfg.n_envs} envs each on {algo.device}")
    state = algo.init_state()
    if args.resume:
        state = leg_overrides(learner, ckpt.restore(args.resume, state, mesh=mesh))
        say(f"resumed from {args.resume} at {ckpt.step_count(state.timesteps)} steps")
    elif args.resume_policy:
        state = ckpt.restore_policy(args.resume_policy, state)
        say(f"warm-started policy from {args.resume_policy} "
            f"at {ckpt.step_count(state.timesteps)} steps")

    last = {"t": time.time(), "steps": ckpt.step_count(state.timesteps)}

    def log_fn(update, metrics):
        if update % args.log_interval or not lead:
            return
        now = time.time()
        steps = ckpt.step_count(metrics["timesteps"])
        sps = (steps - last["steps"]) / max(now - last["t"], 1e-9)
        last.update(t=now, steps=steps)
        line = {
            "update": update,
            "timesteps": steps,
            "steps_per_s": round(sps),
            "ep_rew_mean": float(metrics["ep_rew_mean"]),
            "episodes": float(metrics["episodes"]),
            "completions": int(metrics["completions"]),
            "loss": float(metrics["loss"]),
            "value_loss": float(metrics["value_loss"]),
            "entropy": float(metrics["entropy"]),
            "approx_kl": float(metrics["approx_kl"]),
        }
        print(json.dumps(line), flush=True)
        if logger is not None:
            logger.log({"rollout/ep_rew_mean": line["ep_rew_mean"], "time/steps_per_s": sps,
                        **{f"train/{k}": v for k, v in line.items()}})

    path = f"{args.checkpoint_dir}/{cfg.env_id}"
    saved = {"step": None}

    def save(ts):
        saved["step"] = ckpt.step_count(ts.timesteps)
        if mesh is None:
            ckpt.save(path, ts, saved["step"])
        else:  # every rank writes its shard
            ckpt.save(path, ts, saved["step"], mesh=mesh)

    def checkpoint_fn(update, ts):
        save(ts)
        say(f"periodic checkpoint at update {update} -> {path}", flush=True)

    final = algo.learn(args.total_timesteps, log_fn=log_fn, state=state,
                       checkpoint_fn=checkpoint_fn if args.save_model else None,
                       checkpoint_every=args.checkpoint_every)
    # on the card: how often each graph was captured (once each, unless a
    # call's signature changed mid-run); on the CPU nothing is captured
    say(f"graph captures: {json.dumps(learner.graph_captures)}")
    # the last periodic save may already hold the final step
    if args.save_model and saved["step"] != ckpt.step_count(final.timesteps):
        save(final)
        say(f"saved checkpoint to {path}")
    return final


def script_main():
    """Console-script entry: swallow main()'s return so sys.exit(...) is 0."""
    main()


if __name__ == "__main__":
    main()
