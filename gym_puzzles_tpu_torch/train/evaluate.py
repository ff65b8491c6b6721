"""Policy evaluation (port of ``gym_puzzles_tpu/train/evaluate.py``): the
rebuild of the reference's train/test.py.

The policy runs with its normalizer frozen (VecNormalize training=False,
test.py:66-68), deterministic (the mean action) or stochastic, in a
dedicated eval env: no autoreset, the reference's reset (one random step),
the registered episode limit and, unless overridden, the reference's 180/60
solver iterations.  The eval env rides the fused tick kernel
(``backend='fused'``, any batch size; the plain engine on the CPU).  A pixel policy
(``policy='cnn'``) is evaluated on an image env with its training run's
image pipeline (obs depth, frameskip, downsample, mode, block shape), and
its obs are never normalized.  :func:`record_video` rolls one episode and
renders each state with the host rasterizer.

A completion is an episode that ended with ``done_status`` 3 (success); on
v2 an episode also ends when an agent or the block leaves the bounds (status
1 or 2), and a timeout ends with status 0.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from gym_puzzles_tpu_torch.train import normalize as nrm


def _image_pipeline(algo):
    """The training env's image pipeline (obs_depth, frameskip, downsample,
    mode, block_shape), so that evaluation rebuilds the obs the CNN was
    trained on; None for a flat-obs learner."""
    if algo.obs_shape is None:
        return None
    return algo.env.image_pipeline


def _tick(device) -> str:
    """The engine tick of an env on ``device``: ``'fused'`` (the fused tick
    kernel) on the card, ``'plain'`` (``world.step``) on the CPU."""
    return "fused" if torch.device(device).type == "cuda" else "plain"


def make_eval_env(env_id: str, n: int, device, velocity_iters=None, position_iters=None,
                  image_cfg=None):
    """Eval env of ``n`` lanes: auto_reset off, reference reset, fused tick;
    an image env with the pipeline ``image_cfg`` (see
    :func:`_image_pipeline`) when it is given."""
    from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
    from gym_puzzles_tpu_torch.api.registry import make

    # stderr, so that `evaluate ... > out.json` stays JSON
    print(f"# eval env: {env_id} n={n} backend={_tick(device)}"
          + (f" image pipeline {image_cfg}" if image_cfg is not None else ""), file=sys.stderr)
    iters = dict(velocity_iters=velocity_iters, position_iters=position_iters)
    if image_cfg is not None:
        depth, frameskip, downsample, mode, block_shape = image_cfg
        return DeviceImageVectorEnv(env_id, num_envs=n, obs_depth=depth, frameskip=frameskip,
                                    downsample=downsample, mode=mode, block_shape=block_shape,
                                    auto_reset=False, reset_mode="reference", backend="fused",
                                    device=device, **iters)
    return make(env_id, num_envs=n, auto_reset=False, reset_mode="reference",
                backend="fused", device=device, **iters)


def policy_action(algo, params, norm, obs, deterministic: bool, generator=None):
    """The policy's action on raw ``obs`` ([E, obs_dim], or uint8 frames)
    with the normalizer ``norm`` frozen, clipped to [-1, 1]: the mean, or
    with ``deterministic`` off a sample drawing its noise from
    ``generator``.  Obs are normalized where the learner normalizes them
    (``PPO.use_obs_norm``: flat obs with ``normalize`` on; frames never)."""
    if algo.use_obs_norm:
        obs = nrm.normalize_obs(norm, obs, update=False)[1]
    mean, log_std, _value = algo.apply(params, obs)
    if not deterministic:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        mean = mean + torch.exp(log_std) * noise
    return torch.clamp(mean, -1.0, 1.0)


def _seed(seed: int, n: int) -> int:
    return int(np.random.SeedSequence([seed, n]).generate_state(1)[0])


@torch.no_grad()
def evaluate_policy(algo, train_state, n_episodes: int = 10, deterministic: bool = True,
                    max_steps: int | None = None, seed: int = 0,
                    velocity_iters: int | None = None, position_iters: int | None = None):
    """-> (mean_return, std_return, returns list): ``n_episodes`` episodes one
    after another in a one-lane env, checking ``done`` on the host each step."""
    env = make_eval_env(algo.cfg.env_id, 1, algo.device, velocity_iters, position_iters,
                        _image_pipeline(algo))
    params = env.default_params()
    max_steps = max_steps or env.cfg.max_episode_steps
    gen = torch.Generator(device=algo.device).manual_seed(_seed(seed, 0))
    returns = []
    for ep in range(n_episodes):
        state, obs = env.reset(seed=_seed(seed, ep + 1), params=params)
        total = 0.0
        for _t in range(max_steps):
            action = policy_action(algo, train_state.params, train_state.normalizer, obs,
                          deterministic, gen)
            state, obs, reward, done, _ = env.step(state, action, params)
            total += float(reward[0])
            if bool(done[0]):
                break
        returns.append(total)
    return float(np.mean(returns)), float(np.std(returns)), returns


@torch.no_grad()
def evaluate_policy_batched(algo, train_state, n_episodes: int = 64,
                            deterministic: bool = True, seed: int = 0,
                            max_steps: int | None = None, env_params=None,
                            chunk: int = 200, velocity_iters: int | None = None,
                            position_iters: int | None = None):
    """One episode per env lane, all on the device.  Steps run in
    ``chunk``-step segments with one host check per segment for "every lane
    finished"; a lane's reward and length stop counting once it is done.

    -> (mean_return, std_return, returns list, lengths list, statuses list)
    over ``n_episodes`` episodes; ``lengths`` are the steps until done
    (``max_steps`` for a timeout), ``statuses`` each lane's ``done_status``
    at its first ``done`` (3 success, 1 / 2 out of bounds on v2, 0 for a
    timeout or a lane still running at ``max_steps``)."""
    env = make_eval_env(algo.cfg.env_id, n_episodes, algo.device, velocity_iters,
                        position_iters, _image_pipeline(algo))
    params = env_params if env_params is not None else env.default_params()
    max_steps = max_steps or env.cfg.max_episode_steps
    chunk = min(chunk, max_steps)
    dev = algo.device
    gen = torch.Generator(device=dev).manual_seed(_seed(seed, 0))
    state, obs = env.reset(seed=_seed(seed, 1), params=params)
    finished = torch.zeros((n_episodes,), dtype=torch.bool, device=dev)
    total = torch.zeros((n_episodes,), dtype=torch.float32, device=dev)
    length = torch.zeros((n_episodes,), dtype=torch.int32, device=dev)
    status = torch.zeros((n_episodes,), dtype=torch.int32, device=dev)
    remaining = max_steps
    while remaining > 0:
        n = min(chunk, remaining)  # the last chunk keeps max_steps exact
        for _ in range(n):
            action = policy_action(algo, train_state.params, train_state.normalizer, obs,
                          deterministic, gen)
            state, obs, reward, done, info = env.step(state, action, params)
            total = total + torch.where(finished, 0.0, reward)
            length = length + (~finished).int()
            status = torch.where(finished, status, info["done_status"])
            finished = finished | done
        remaining -= n
        if bool(finished.all()):
            break
    totals = total.cpu().numpy()
    return (float(totals.mean()), float(totals.std()), totals.tolist(),
            length.cpu().tolist(), status.cpu().tolist())


def eval_backend(algo) -> str:
    """What the eval env runs: the image env's name for a pixel policy, else
    its engine tick (:func:`_tick`)."""
    return "device-image" if algo.obs_shape is not None else _tick(algo.device)


@torch.no_grad()
def record_video(algo, train_state, path: str, n_steps: int = 300, seed: int = 0,
                 mode: str = "human_vision", fps: int = 50, velocity_iters: int | None = None,
                 position_iters: int | None = None):
    """Roll one deterministic episode (at most ``n_steps`` steps) in a
    one-lane eval env on ``algo.device`` and render the state before each
    step with the host rasterizer.  Writes ``path``.npz (``frames`` [N, H, W,
    3] uint8, ``fps``) always and ``path``.gif when PIL imports; returns the
    frames."""
    from gym_puzzles_tpu_torch.render.raster import render_batch

    env = make_eval_env(algo.cfg.env_id, 1, algo.device, velocity_iters, position_iters,
                        _image_pipeline(algo))
    params = env.default_params()
    state, obs = env.reset(seed=seed, params=params)
    frames = []
    for _ in range(n_steps):
        env_state = state.vec if algo.obs_shape is not None else state
        frames.append(render_batch(env.logic, env_state, [0], mode=mode)[0])
        action = policy_action(algo, train_state.params, train_state.normalizer, obs, True)
        state, obs, reward, done, _ = env.step(state, action, params)
        if bool(done[0]):
            break
    frames = np.stack(frames)
    np.savez_compressed(path + ".npz", frames=frames, fps=fps)
    try:
        from PIL import Image
    except ImportError:
        return frames
    imgs = [Image.fromarray(f) for f in frames[:: max(1, fps // 10)]]
    imgs[0].save(path + ".gif", save_all=True, append_images=imgs[1:], duration=1000 // 10,
                 loop=0)
    return frames


def main(argv=None):
    """``python -m gym_puzzles_tpu_torch.train.evaluate``: restore a policy
    (a checkpoint directory or a policy ``.npz``), evaluate N episodes and
    print one JSON line (returns; batched: lengths, each episode's
    ``done_status`` and completions = episodes that ended in success),
    optionally record one episode's video."""
    from gym_puzzles_tpu_torch import convert
    from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
    from gym_puzzles_tpu_torch.train import checkpoint as ckpt
    from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig

    p = argparse.ArgumentParser(description="Evaluate a trained policy")
    p.add_argument("--checkpoint", required=True, type=str,
                   help="checkpoint directory written by the trainer CLI, or a policy .npz")
    p.add_argument("--config", default=None, type=str, help="JSON config path")
    p.add_argument("--env", default=None, type=str, help="env id override")
    p.add_argument("--policy", default=None, choices=["mlp", "cnn"],
                   help="policy architecture of the checkpoint (a pixel policy .npz says "
                        "so itself)")
    p.add_argument("--downsample", default=4, type=int,
                   help="cnn only: frame downsample the checkpoint was trained with (it "
                        "sets the CNN's flatten width)")
    p.add_argument("--obs_depth", default=3, type=int,
                   help="cnn only: stacked frame count (00.py:197-200)")
    p.add_argument("--frameskip", default=4, type=int,
                   help="cnn only: physics frameskip (00.py:161-162)")
    p.add_argument("--n_episodes", default=10, type=int)
    p.add_argument("--max_steps", default=None, type=int,
                   help="episode step cap (default: the env's registered max_episode_steps)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--stochastic", action="store_true",
                   help="sample actions instead of the deterministic mean")
    p.add_argument("--batched", action="store_true",
                   help="one episode per env lane on the device")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default cuda; 'cpu' runs the plain engine)")
    p.add_argument("--velocity_iters", default=None, type=int,
                   help="solver velocity iterations of the eval env (default: the "
                        "reference's 180; fewer only for smoke runs)")
    p.add_argument("--position_iters", default=None, type=int,
                   help="solver position iterations of the eval env (default 60)")
    p.add_argument("--video", default=None, type=str,
                   help="record one episode to PATH.npz (and PATH.gif where PIL imports)")
    p.add_argument("--video_mode", default="human_vision",
                   choices=["human_vision", "agent_vision"])
    args = p.parse_args(argv)

    config = {}
    if args.config:
        with open(args.config) as f:
            config = json.load(f)
    overrides = {"n_envs": 1, "n_steps": 2, "batch_size": 2, "n_epochs": 1}
    if args.env:
        overrides["env_id"] = args.env
    # a pixel policy file records its image pipeline; else the flags give it
    image_cfg = (convert.policy_from_npz(args.checkpoint).image_pipeline
                 if args.checkpoint.endswith(".npz") else None)
    if args.policy or image_cfg is not None:
        overrides["policy"] = "cnn" if image_cfg is not None else args.policy
    cfg = PPOConfig.from_reference_json(config, **overrides)
    env = None
    if cfg.policy == "cnn":
        image_cfg = image_cfg or (args.obs_depth, args.frameskip, args.downsample,
                                  "human_vision", "t")
        depth, frameskip, downsample, mode, block_shape = image_cfg
        env = DeviceImageVectorEnv(cfg.env_id, num_envs=cfg.n_envs, obs_depth=depth,
                                   frameskip=frameskip, downsample=downsample, mode=mode,
                                   block_shape=block_shape, device=args.device)
    algo = PPO(cfg, device=args.device, env=env)
    state = ckpt.restore_policy(args.checkpoint, algo.init_state(args.seed))
    iters = dict(velocity_iters=args.velocity_iters, position_iters=args.position_iters)

    lengths = None
    if args.batched:
        mean, std, returns, lengths, statuses = evaluate_policy_batched(
            algo, state, n_episodes=args.n_episodes, seed=args.seed,
            max_steps=args.max_steps, deterministic=not args.stochastic, **iters)
    else:
        mean, std, returns = evaluate_policy(
            algo, state, n_episodes=args.n_episodes, seed=args.seed,
            max_steps=args.max_steps, deterministic=not args.stochastic, **iters)
    from gym_puzzles_tpu_torch.envs.config import VARIANTS

    ecfg = VARIANTS[cfg.env_id]
    max_steps = args.max_steps or ecfg.max_episode_steps
    row = {"env_id": cfg.env_id, "checkpoint": args.checkpoint,
           "trained_timesteps": ckpt.step_count(state.timesteps),
           "device": (torch.cuda.get_device_name(algo.device) if algo.device.type == "cuda"
                      else str(algo.device)),
           "policy": cfg.policy, "image_pipeline": _image_pipeline(algo),
           "eval_backend": eval_backend(algo), "batched": args.batched,
           "eval_solver_iters": [args.velocity_iters or ecfg.velocity_iters,
                                 args.position_iters or ecfg.position_iters],
           "max_steps": max_steps, "mean_return": mean, "std_return": std,
           "returns": returns}
    if lengths is not None:
        row["lengths"] = lengths
        row["done_status"] = statuses
        row["completions"] = sum(1 for st in statuses if st == 3)
    print(json.dumps(row))
    if args.video:
        frames = record_video(algo, state, args.video, seed=args.seed, mode=args.video_mode,
                              **iters)
        print(f"video: {len(frames)} frames written to {args.video}.npz")
    return mean, std, returns


def script_main():
    """Console-script entry: swallow main()'s return so sys.exit(...) is 0."""
    main()


if __name__ == "__main__":
    main()
