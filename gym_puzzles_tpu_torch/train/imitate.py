"""Imitation bootstrap (port of ``gym_puzzles_tpu/train/imitate.py``):
behaviour-clone a scripted demonstrator and write a full TrainState
checkpoint that the PPO trainer can ``--resume``.

The v0-family reward structure makes Heavy-v0 a speed problem (a policy that
completes at 1850 steps still nets a large negative return under the
per-step distance penalties).  The scripted herd-and-push controller
(``train/scripted.py``) demonstrates fast completions; this tool distills it
into the ActorCritic MLP by supervised regression on the demonstrator's
own rollouts, and hands the result to PPO for reward finetuning:

    python -m gym_puzzles_tpu_torch.train.imitate --env MultiRobotPuzzleHeavy-v0 \\
        --n_envs 4096 --rounds 60 --out models/hv0_bc
    python -m gym_puzzles_tpu_torch.train.cli --env MultiRobotPuzzleHeavy-v0 ... \\
        --resume models/hv0_bc/MultiRobotPuzzleHeavy-v0 ...

The checkpoint is the trainer's own TrainState (params, a fresh PPO Adam
state, the normalizer with the demonstrator's obs statistics, the env batch,
the generators), so ``train.cli --resume`` and ``evaluate --checkpoint``
read it unchanged.  The value head is regressed toward the running
normalized-return signal so that PPO's first updates start from sane
advantages.  The rollouts run on the learner's device: on the card each env
step is one launch of the fused tick kernel.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gym_puzzles_tpu_torch.train import normalize as nrm
from gym_puzzles_tpu_torch.train.ppo import PPO, AdamState, adam_update
from gym_puzzles_tpu_torch.train.scripted import pusher_action

# optax.adam's epsilon (the BC optimizer is plain optax.adam, no clipping)
BC_ADAM_EPS = 1e-8
LOG_STD_TARGET = float(np.log(0.2))


def bc_opt_init(params: dict) -> AdamState:
    """A fresh Adam state for the BC regression."""
    return AdamState.zeros_like(params)


def bc_loss(algo, params, obs_n, act, ret_n):
    """-> (total, (pi_mse, v_mse)): ``MSE(mean, act) + 0.1 (log_std - log
    0.2)^2 + 0.5 MSE(value, ret)``."""
    mean, log_std, value = algo.apply(params, obs_n)
    pi_loss = ((mean - act) ** 2).mean()
    std_loss = ((log_std - LOG_STD_TARGET) ** 2).mean()
    v_loss = ((value - ret_n) ** 2).mean()
    return pi_loss + 0.1 * std_loss + 0.5 * v_loss, (pi_loss, v_loss)


def bc_round(algo: PPO, ts, bc_opt: AdamState, bc_lr: float = 1e-3, offset_px: float = 70.0,
             perms=None):
    """One BC round -> (ts, bc_opt, metrics [n_epochs * n_minibatch, 3] of
    (loss, pi_mse, v_mse) per minibatch).

    Rolls ``n_steps`` demonstrator steps through the training env (autoreset
    on), updating the obs and return normalizer as the PPO rollout does;
    builds the discounted normalized-return proxy, with ``done`` masking the
    accumulator so returns do not bleed across autoresets; then runs
    ``n_epochs`` epochs of ``batch_size`` minibatches of :func:`bc_loss`,
    each followed by a plain Adam step at ``bc_lr``.  ``perms``
    [n_epochs, n_steps * n_envs] is each epoch's minibatch order (default:
    ``torch.randperm`` from ``ts.generator``)."""
    cfg, env, dev = algo.cfg, algo.env, algo.device
    T, E = cfg.n_steps, cfg.n_envs
    total = T * E
    n_minibatch = max(total // cfg.batch_size, 1)
    num_agents = env.cfg.act_dim // 3
    obs_n = torch.empty((T, E, algo.obs_dim), device=dev)
    acts = torch.empty((T, E, algo.act_dim), device=dev)
    rew_n = torch.empty((T, E), device=dev)
    dones = torch.empty((T, E), dtype=torch.bool, device=dev)
    vstate, obs, norm = ts.vstate, ts.last_obs, ts.normalizer
    with torch.no_grad():
        for t in range(T):
            act = pusher_action(obs, num_agents, offset_px)
            vstate, next_obs, reward, done, _ = env.step(vstate, act, algo.env_params)
            norm, obs_n[t] = nrm.normalize_obs(norm, obs, update=True)
            norm, rew_n[t] = nrm.normalize_reward(norm, reward, done, update=True)
            acts[t], dones[t] = act, done
            obs = next_obs
        ret_n = torch.empty_like(rew_n)
        c = torch.zeros_like(rew_n[0])
        for t in reversed(range(T)):
            c = rew_n[t] + cfg.gamma * c * (1.0 - dones[t].float())
            ret_n[t] = c
    flat_obs, flat_act, flat_ret = (obs_n.reshape(total, -1), acts.reshape(total, -1),
                                    ret_n.reshape(total))
    if perms is None:
        perms = torch.stack([torch.randperm(total, generator=ts.generator, device=dev)
                             for _ in range(cfg.n_epochs)])
    params = {k: v.detach().requires_grad_() for k, v in ts.params.items()}
    metrics = []
    for epoch in range(cfg.n_epochs):
        idxs = perms[epoch, : n_minibatch * cfg.batch_size].view(n_minibatch, cfg.batch_size)
        for idx in idxs:
            loss, (pi, v) = bc_loss(algo, params, flat_obs[idx], flat_act[idx], flat_ret[idx])
            grads = torch.autograd.grad(loss, list(params.values()))
            params, bc_opt = adam_update(params, list(grads), bc_opt, bc_lr, BC_ADAM_EPS)
            params = {k: p.requires_grad_() for k, p in params.items()}
            metrics.append(torch.stack([loss.detach(), pi.detach(), v.detach()]))
    ts = ts.replace(params={k: p.detach() for k, p in params.items()}, vstate=vstate,
                    last_obs=obs, normalizer=norm, timesteps=ts.timesteps + total)
    return ts, bc_opt, torch.stack(metrics)


def bc_train(cfg, rounds: int = 60, bc_lr: float = 1e-3, offset_px: float = 70.0,
             log_every: int = 10, log_fn=print, device=None):
    """-> (PPO learner, TrainState with the distilled params) after
    ``rounds`` of :func:`bc_round`, starting from ``PPO(cfg).init_state()``
    on ``device`` (default ``cuda``; with no CUDA and no device named this
    raises).  Every ``log_every`` rounds and after the last, ``log_fn`` gets
    one JSON line of the round's mean loss, pi_mse and v_mse."""
    algo = PPO(cfg, device=device)
    ts = algo.init_state()
    bc_opt = bc_opt_init(ts.params)
    for r in range(rounds):
        ts, bc_opt, metrics = bc_round(algo, ts, bc_opt, bc_lr, offset_px)
        if r % log_every == 0 or r == rounds - 1:
            loss, pi, v = metrics.mean(dim=0).tolist()
            log_fn(json.dumps({"bc_round": r, "loss": loss, "pi_mse": pi, "v_mse": v}))
    return algo, ts


def main(argv=None):
    """``python -m gym_puzzles_tpu_torch.train.imitate``: behaviour-clone the
    scripted pusher and save the TrainState to ``<out>/<env id>``."""
    from gym_puzzles_tpu_torch.train import checkpoint as ckpt
    from gym_puzzles_tpu_torch.train.ppo import PPOConfig

    p = argparse.ArgumentParser(description="behaviour-clone the scripted pusher")
    p.add_argument("--env", default="MultiRobotPuzzleHeavy-v0")
    p.add_argument("--n_envs", default=4096, type=int)
    p.add_argument("--n_steps", default=64, type=int)
    p.add_argument("--batch_size", default=8192, type=int)
    p.add_argument("--n_epochs", default=4, type=int)
    p.add_argument("--rounds", default=60, type=int)
    p.add_argument("--bc_lr", default=1e-3, type=float)
    p.add_argument("--offset_px", default=70.0, type=float)
    p.add_argument("--gamma", default=0.999, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--env_backend", default="fused", choices=["fused", "pallas"],
                   help="engine tick: fused = one launch of the fused tick kernel per step, "
                        "pallas = the staged tick around the contact-solve kernel")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default cuda; 'cpu' runs the plain engine)")
    p.add_argument("--velocity_iters", default=None, type=int,
                   help="solver velocity iterations (default: the reference's 180)")
    p.add_argument("--position_iters", default=None, type=int,
                   help="solver position iterations (default: the reference's 60)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    cfg = PPOConfig(env_id=args.env, n_envs=args.n_envs, n_steps=args.n_steps,
                    batch_size=args.batch_size, n_epochs=args.n_epochs, gamma=args.gamma,
                    seed=args.seed, env_backend=args.env_backend,
                    velocity_iters=args.velocity_iters, position_iters=args.position_iters)
    algo, ts = bc_train(cfg, rounds=args.rounds, bc_lr=args.bc_lr, offset_px=args.offset_px,
                        device=args.device)
    path = f"{args.out}/{cfg.env_id}"
    step = ckpt.step_count(ts.timesteps)
    ckpt.save(path, ts, step)
    print(f"saved BC checkpoint to {path} ({step} demo steps)")
    return algo, ts


def script_main():
    """Console-script entry: swallow main()'s return so sys.exit(...) is 0."""
    main()


if __name__ == "__main__":
    main()
