"""The PPO update in plain PyTorch: policy forward passes, observation and
reward normalization, GAE, the clipped loss, global-norm clipping, Adam and
the target-KL stop as a mask.

A frozen copy of the arithmetic of the port's ``train/networks.py``,
``train/normalize.py`` and ``train/ppo.py`` (``compute_gae``, ``loss``,
``adam_step``, ``minibatch_steps``, ``learn_steps``), written as eager ops on
a dict of parameters.  Parameters are keyed as the port's ``state_dict``:
``trunk.<i>.weight`` / ``convs.<i>.weight`` / ``dense.weight`` ...,
``mean.*``, ``value.*`` and ``log_std``.

``conv_dtype`` is the precision of the CNN's convolutions (the pixel
configuration states bfloat16).  ``lower=True`` gives the control the next
precision below the configuration's: the dense layers' operands rounded to
TF32 (10 mantissa bits, float32 sums) and the convolutions' to fp8 (e4m3).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5
CLIP_OBS = CLIP_REWARD = 10.0
NORM_EPS = 1e-8
_LOG_2PI = float(np.log(np.float32(2.0 * math.pi)))
_HALF_LOG_2PIE = float(np.float32(0.5) * np.log(np.float32(2.0 * math.pi * math.e)))
_ADAM_DECAYS = (float(np.float32(ADAM_B1)), float(np.float32(ADAM_B2)))
CNN_STRIDES = (4, 2, 1)


@contextlib.contextmanager
def precision():
    """Matmuls and convolutions in full float32: TF32 off."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(x):
    """``x`` rounded through fp8 (e4m3); the gradient passes as it is."""
    return x + (x.detach().to(torch.float8_e4m3fn).to(x.dtype) - x.detach())


def _tf32(x):
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest; the
    gradient passes as it is."""
    bits = x.detach().contiguous().view(torch.int32)
    return x + (((bits + 0x1000) & -0x2000).view(torch.float32) - x.detach())


def _linear(x, w, b, lower: bool):
    return F.linear(_tf32(x), _tf32(w), b) if lower else F.linear(x, w, b)


def forward(params: dict, obs, conv_dtype=torch.bfloat16, lower: bool = False):
    """(mean, log_std, value) of the MLP (float32 ``obs`` [N, obs_dim]) or the
    NatureCNN (uint8 frames [N, H, W, C]): tanh trunk / three VALID
    convolutions with ReLU, NHWC flatten, dense ReLU; linear heads."""
    P = params
    if "convs.0.weight" not in P:
        x = obs
        i = 0
        while f"trunk.{i}.weight" in P:
            x = torch.tanh(_linear(x, P[f"trunk.{i}.weight"], P[f"trunk.{i}.bias"], lower))
            i += 1
    else:
        x = (obs.to(torch.float32) / 255.0).to(conv_dtype).permute(0, 3, 1, 2)
        for i, stride in enumerate(CNN_STRIDES):
            w = P[f"convs.{i}.weight"].to(conv_dtype)
            if lower:
                x, w = _fp8(x), _fp8(w)
            y = F.conv2d(x, w, stride=stride)
            x = torch.relu(y + P[f"convs.{i}.bias"].to(conv_dtype)[:, None, None])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(torch.float32)
        x = torch.relu(_linear(x, P["dense.weight"], P["dense.bias"], lower))
    mean = _linear(x, P["mean.weight"], P["mean.bias"], lower)
    value = _linear(x, P["value.weight"], P["value.bias"], lower)[..., 0]
    return mean, P["log_std"], value


def log_prob(mean, log_std, action):
    var = torch.exp(2.0 * log_std)
    return (-0.5 * ((action - mean) ** 2 / var + 2.0 * log_std + _LOG_2PI)).sum(dim=-1)


def entropy(log_std):
    return (log_std + _HALF_LOG_2PIE).sum()


# -- normalization (VecNormalize) -------------------------------------------

def rms_update(rms: dict, batch) -> dict:
    """Parallel Welford update of {mean, var, count} over the leading axis."""
    b_mean = batch.mean(dim=0)
    b_var = batch.var(dim=0, correction=0)
    b_count = float(batch.shape[0])
    delta = b_mean - rms["mean"]
    tot = rms["count"] + b_count
    mean = rms["mean"] + delta * b_count / tot
    m2 = rms["var"] * rms["count"] + b_var * b_count + delta**2 * rms["count"] * b_count / tot
    return {"mean": mean, "var": m2 / tot, "count": tot}


def normalize_obs(rms: dict, obs):
    n = (obs - rms["mean"]) / torch.sqrt(rms["var"] + NORM_EPS)
    return torch.clamp(n, -CLIP_OBS, CLIP_OBS)


def normalize_reward(ret_rms: dict, returns, gamma: float, reward, done):
    """-> (ret_rms', returns', normalized reward): the discounted return is
    updated before the statistics and reset where done."""
    returns = returns * gamma + reward
    ret_rms = rms_update(ret_rms, returns)
    n = reward / torch.sqrt(ret_rms["var"] + NORM_EPS)
    return ret_rms, torch.where(done, 0.0, returns), torch.clamp(n, -CLIP_REWARD, CLIP_REWARD)


# -- the update ---------------------------------------------------------------

def gae(value, reward, done, last_value, gamma, gae_lambda):
    """GAE with SB3's semantics -> (advantages, returns), [T, E]."""
    gamma = torch.tensor(gamma, dtype=torch.float32, device=value.device)
    gae_lambda = torch.tensor(gae_lambda, dtype=torch.float32, device=value.device)
    gl = gamma * gae_lambda
    adv = torch.empty_like(value)
    run = torch.zeros_like(last_value)
    nxt = last_value
    for t in reversed(range(value.shape[0])):
        nonterminal = 1.0 - done[t].float()
        delta = reward[t] + gamma * nxt * nonterminal - value[t]
        run = delta + gl * nonterminal * run
        adv[t] = run
        nxt = value[t]
    return adv, adv + value


def loss(params, obs, action, old_lp, adv, ret, hp: dict, **fw):
    mean, log_std, value = forward(params, obs, **fw)
    lp = log_prob(mean, log_std, action)
    ratio = torch.exp(lp - old_lp)
    a = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    clip = torch.tensor(hp["clip_range"], dtype=torch.float32, device=obs.device)
    clipped = torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    pg = -torch.minimum(a * ratio, a * clipped).mean()
    vl = ((ret - value) ** 2).mean()
    total = pg + _f(hp["vf_coef"], obs) * vl - _f(hp["ent_coef"], obs) * entropy(log_std)
    with torch.no_grad():
        kl = ((ratio - 1.0) - torch.log(ratio)).mean()
    return total, kl


def _f(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def adam(params: dict, grads: dict, opt: dict, hp: dict):
    """Global-norm clip, then optax's ``scale_by_adam`` and a ``-lr`` step ->
    (params, opt) with opt = {mu, nu, count}."""
    g_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                   for g in grads.values()]))
    clip = torch.clamp(_f(hp["max_grad_norm"], g_norm) / (g_norm + 1e-6), max=1.0)
    count = opt["count"] + 1
    c = count.to(torch.float64)
    bc1, bc2 = (1.0 - torch.pow(b, c).to(torch.float32) for b in _ADAM_DECAYS)
    lr = _f(hp["learning_rate"], g_norm)
    new_p, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k] * clip
        mu[k] = g * (1 - ADAM_B1) + opt["mu"][k] * ADAM_B1
        nu[k] = (g * g) * (1 - ADAM_B2) + opt["nu"][k] * ADAM_B2
        step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
        new_p[k] = p + step * -lr
    return new_p, {"mu": mu, "nu": nu, "count": count}


def update(params: dict, opt: dict, traj: dict, last_value, perms, hp: dict,
           batch_size: int, half: bool = False, reverse: bool = False, **fw) -> tuple:
    """One learner pass over a rollout ``traj`` (obs, action, log_prob,
    value, reward, done; [T, E, ...]): GAE, then every minibatch of every
    epoch in ``perms`` [n_epochs, T * E] order, with the target-KL stop
    freezing params and Adam state from the minibatch after the one whose KL
    passes ``1.5 * target_kl``.  -> (params, opt, mean total loss over every
    minibatch, minibatches applied).

    ``half`` plants a fault: each minibatch's loss over its first half.
    ``reverse`` takes each minibatch's samples in reverse order: the same
    arithmetic with its sums in another order, a sound twin of the
    reference that shows the round-off floor of each number."""
    with torch.no_grad():
        adv, ret = gae(traj["value"], traj["reward"], traj["done"], last_value,
                       hp["gamma"], hp["gae_lambda"])
    total = traj["done"].numel()
    flat = lambda x: x.reshape((total,) + x.shape[2:])  # noqa: E731
    obs, action, old_lp, adv, ret = (flat(traj["obs"]), flat(traj["action"]),
                                     flat(traj["log_prob"]), flat(adv), flat(ret))
    mb = max(1, min(batch_size, total))
    n_mb = max(1, total // mb)
    idxs = perms[:, : n_mb * mb].reshape(-1, mb)
    if half:
        idxs = idxs[:, : mb // 2]
    if reverse:
        idxs = idxs.flip(-1)
    limit = _f(1.5, obs.new_zeros(())) * _f(hp["target_kl"], obs.new_zeros(()))
    stopped, applied, losses = False, 0, []
    for idx in idxs:
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        tot, kl = loss(p, obs[idx], action[idx], old_lp[idx], adv[idx], ret[idx], hp, **fw)
        grads = dict(zip(p, torch.autograd.grad(tot, list(p.values()))))
        losses.append(tot.detach())
        if stopped:
            continue
        params, opt = adam({k: v.detach() for k, v in p.items()}, grads, opt, hp)
        applied += 1
        stopped = bool(hp["target_kl"] > 0 and kl > limit)
    return params, opt, torch.stack(losses).mean(), applied
