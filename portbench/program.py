"""The system under test, built from a configuration file through the port's
public entries: ``gym_puzzles_tpu_torch.make``, ``DeviceImageVectorEnv`` and
``PPO``.  The weights are the benchmark's own, drawn on the device from the
seed; nothing is loaded from disk but the kernels' shared libraries, which the
port builds into its own ``_build/`` directory inside the checkout.
"""

from __future__ import annotations

import math

import torch


def make_env(config: dict, device):
    """The config's batched env: the image env when it names an ``image``
    pipeline, else the flat vector env."""
    from gym_puzzles_tpu_torch import make
    from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv

    env = config["env"]
    if config.get("image"):
        img = config["image"]
        return DeviceImageVectorEnv(env["env_id"], num_envs=env["num_envs"],
                                    obs_depth=img["obs_depth"], frameskip=img["frameskip"],
                                    downsample=img["downsample"], backend=env["backend"],
                                    reset_mode=env["reset_mode"],
                                    velocity_iters=env["velocity_iters"],
                                    position_iters=env["position_iters"], device=device)
    return make(env["env_id"], num_envs=env["num_envs"], backend=env["backend"],
                reset_mode=env["reset_mode"], velocity_iters=env["velocity_iters"],
                position_iters=env["position_iters"], device=device)


def make_ppo(config: dict, device):
    """The config's PPO learner on its env."""
    from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig

    env, ppo = config["env"], dict(config["ppo"])
    ppo["net_arch"] = tuple(ppo.get("net_arch", (256, 256)))
    cfg = PPOConfig(env_id=env["env_id"], n_envs=env["num_envs"], env_backend=env["backend"],
                    velocity_iters=env["velocity_iters"], position_iters=env["position_iters"],
                    **ppo)
    return PPO(cfg, device=device, env=make_env(config, device))


def orthogonal(shape, gain: float, generator) -> torch.Tensor:
    """An orthogonal matrix of ``shape`` (rows flattened over the trailing
    dims) scaled by ``gain``, from one normal draw on the generator's device
    and one QR."""
    rows, cols = shape[0], math.prod(shape[1:])
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                    device=generator.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return (gain * q).reshape(shape).contiguous()


def make_weights(template: dict, seed: int, device) -> dict:
    """Fresh policy weights shaped as ``template`` (the net's ``state_dict``),
    drawn on ``device`` from ``seed``: orthogonal matrices with the recipe's
    gains (sqrt 2 for the trunk, convolutions and dense layer, 0.01 for the
    mean head, 1 for the value head), zero biases and ``log_std``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, v in template.items():
        if k.endswith(".weight"):
            gain = 0.01 if k.startswith("mean.") else 1.0 if k.startswith("value.") else math.sqrt(2)
            out[k] = orthogonal(tuple(v.shape), gain, gen)
        else:
            out[k] = torch.zeros(tuple(v.shape), dtype=torch.float32, device=device)
    return out
