"""PPO learner (port of ``gym_puzzles_tpu/train/ppo.py``).

Two policies: ``policy='mlp'`` (flat observations, :class:`ActorCritic`) and
``policy='cnn'`` (stacked uint8 frames rendered on the device by
:class:`DeviceImageVectorEnv`, :class:`CnnActorCritic`).

One :meth:`PPO.train_step` is one update, in three parts that can be called
alone:

1. :meth:`PPO.rollout` steps the vectorized env ``n_steps`` times on the
   device (``VectorEnv.step``; with ``env_backend='fused'``, the default,
   each step is one launch of the fused tick kernel);
2. :func:`compute_gae` computes GAE(gamma, lambda) advantages;
3. :meth:`PPO.update` runs ``n_epochs`` x minibatch SGD with the clipped
   surrogate, entropy bonus, value loss, global-norm gradient clipping, an
   Adam step written as ``optax.scale_by_adam`` computes it, and the JAX
   package's target-KL stop.

Randomness comes from two ``torch.Generator`` s on the device: the
learner's (action noise and minibatch order) and the env's own (spawns).
Both ride the :class:`TrainState` and advance in place.  The rollout and
the update take the action noise and the minibatch order as arguments too,
so that a test can give them.

Data parallelism (``parallel/mesh.py``): the rollout, the update and
:meth:`PPO.train_step` take a ``mesh`` (the process group of the ranks,
each with its own share of the envs) and sync at the JAX package's points:
the normalizer and episode statistics once per update, the gradients and the
KL in one all-reduce per minibatch, the loss metrics and completions at the
end.  With ``mesh=None`` nothing is synced.

Hyperparameter names and defaults mirror train/configs/ppo-mrp-*.json, so
the reference's configs load directly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
from gym_puzzles_tpu_torch.api.registry import make
from gym_puzzles_tpu_torch.api.vector import resolve_device
from gym_puzzles_tpu_torch.engine.types import Replaceable
from gym_puzzles_tpu_torch.envs.common import EnvState
from gym_puzzles_tpu_torch.envs.config import RewardParams, _f32
from gym_puzzles_tpu_torch.train import normalize as nrm
from gym_puzzles_tpu_torch.train.networks import (ActorCritic, CnnActorCritic,
                                                  gaussian_entropy, gaussian_log_prob)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    env_id: str = "MultiRobotPuzzle-v0"
    n_envs: int = 6
    n_steps: int = 4096
    batch_size: int = 128
    n_epochs: int = 10
    learning_rate: float = 0.00063
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    target_kl: float | None = 0.01
    net_arch: tuple = (256, 256)
    # 'mlp' (SB3 MlpPolicy on flat obs) | 'cnn' (SB3 CnnPolicy on the v0
    # image-obs pipeline rendered on the device, 00.py:161-162,197-200)
    policy: str = "mlp"
    normalize: bool = True
    seed: int = 17
    total_timesteps: int = 1_000_000
    # engine tick behind each env step: 'fused' = one launch of the fused
    # tick kernel, 'pallas' = the staged tick around the contact-solve kernel
    env_backend: str = "fused"
    # Reward curriculum (the reference trainer's update_params /
    # update_goal hooks, 02.py:227-230, 00.py:245-246)
    update_params_decay: float | None = None
    update_goal: bool = False
    # linear lr decay over the run (SB3's learning_rate=linear_schedule)
    anneal_lr: bool = False
    # reward-weight overrides by the reference's set_reward_params names,
    # e.g. (("agentDelta", 30.0), ("blockDelta", 400.0))
    reward_params: tuple = ()
    # anneal the reward_params overrides back to the defaults over the
    # first N updates (0 = hold them fixed)
    reward_anneal_updates: int = 0
    # solver iterations (None = the reference's 180/60)
    velocity_iters: int | None = None
    position_iters: int | None = None
    # training-horizon override (None = the registered max_episode_steps)
    max_episode_steps: int | None = None

    @staticmethod
    def from_reference_json(config: dict, **overrides) -> "PPOConfig":
        """Load a reference train/configs/*.json dict (train.py:33-41)."""
        alg = dict(config.get("alg_params", {}))
        kw: dict[str, Any] = dict(
            env_id=config.get("env", "MultiRobotPuzzle-v0"),
            n_envs=config.get("n_envs", 6),
        )
        for k in ("learning_rate", "n_steps", "batch_size", "n_epochs", "gamma",
                  "gae_lambda", "clip_range", "ent_coef", "vf_coef",
                  "max_grad_norm", "target_kl"):
            if k in alg:
                kw[k] = alg[k]
        net = alg.get("policy_kwargs", {}).get("net_arch")
        if net:
            kw["net_arch"] = tuple(net)
        kw.update(overrides)
        return PPOConfig(**kw)


@dataclasses.dataclass
class HParams(Replaceable):
    """Optimization knobs read on every step, as Python floats holding
    float32 values: a sweep or a schedule changes them between updates.
    ``lr_base`` is what ``anneal_lr`` scales; ``target_kl <= 0`` disables
    the KL stop."""

    learning_rate: float
    lr_base: float
    clip_range: float
    ent_coef: float
    vf_coef: float
    max_grad_norm: float
    target_kl: float
    gamma: float
    gae_lambda: float

    @staticmethod
    def from_config(cfg: PPOConfig) -> "HParams":
        return HParams(
            learning_rate=_f32(cfg.learning_rate),
            lr_base=_f32(cfg.learning_rate),
            clip_range=_f32(cfg.clip_range),
            ent_coef=_f32(cfg.ent_coef),
            vf_coef=_f32(cfg.vf_coef),
            max_grad_norm=_f32(cfg.max_grad_norm),
            target_kl=_f32(cfg.target_kl if cfg.target_kl is not None else 0.0),
            gamma=_f32(cfg.gamma),
            gae_lambda=_f32(cfg.gae_lambda),
        )


@dataclasses.dataclass
class AdamState(Replaceable):
    """``optax.scale_by_adam``'s state: the moments keyed as the params,
    and the step count."""

    mu: dict
    nu: dict
    count: int


@dataclasses.dataclass
class TrainState(Replaceable):
    params: dict  # ActorCritic state_dict: name -> tensor
    opt_state: AdamState
    normalizer: nrm.NormalizerState
    vstate: EnvState
    last_obs: torch.Tensor  # [E, obs_dim] raw, or [E, h * depth, w, 3] uint8 frames
    generator: torch.Generator  # action noise and minibatch order
    env_generator: torch.Generator  # the env's own (spawns); the VectorEnv's
    timesteps: torch.Tensor  # [] int64 env steps consumed
    ep_return: torch.Tensor  # [E] running raw episode returns
    ep_len: torch.Tensor  # [E] int32
    stat_return: torch.Tensor  # [] float32 sum of completed episode returns
    stat_count: torch.Tensor  # [] float32 completed episodes
    env_params: RewardParams  # curriculum state
    hparams: HParams
    # the image env's (obs_depth, frameskip, downsample, mode, block_shape),
    # so that a checkpoint records how its frames were made; None for flat obs
    image_pipeline: tuple | None = None


@dataclasses.dataclass
class Transition:
    """One rollout, [n_steps, n_envs, ...] per field."""

    obs: torch.Tensor  # normalized (flat), or the uint8 frames
    action: torch.Tensor  # unclipped
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor  # normalized
    done: torch.Tensor
    status: torch.Tensor


class PhaseTimer:
    """Wall seconds by part of an update (``env``, ``render`` on the image
    env, ``policy``, ``gae``, ``update``), for measurement only: each part
    starts and ends with a device synchronise, which the untimed path never
    does."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def _untimed(name):
    return contextlib.nullcontext()


def compute_gae(traj: Transition, last_value, gamma: float, gae_lambda: float):
    """GAE with SB3's semantics (``done`` marks an episode boundary) ->
    (advantages, returns), both [n_steps, n_envs]."""
    gl = _f32(np.float32(gamma) * np.float32(gae_lambda))
    advantages = torch.empty_like(traj.value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(traj.value.shape[0])):
        nonterminal = 1.0 - traj.done[t].float()
        delta = traj.reward[t] + gamma * next_value * nonterminal - traj.value[t]
        gae = delta + gl * nonterminal * gae
        advantages[t] = gae
        next_value = traj.value[t]
    return advantages, advantages + traj.value


@torch.no_grad()
def adam_update(params: dict, grads: list, opt: AdamState, lr: float, eps: float = ADAM_EPS):
    """``optax.scale_by_adam`` (b1 0.9, b2 0.999, ``eps`` added after the
    square root) and a ``-lr`` step -> (params, opt_state).  Out of place:
    the inputs are left as they were."""
    keys = list(params)
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - ADAM_B1),
                            torch._foreach_mul([opt.mu[k] for k in keys], ADAM_B1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - ADAM_B2),
                            torch._foreach_mul([opt.nu[k] for k in keys], ADAM_B2))
    count = opt.count + 1
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(count))
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
    step = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    new = torch._foreach_add([params[k] for k in keys], torch._foreach_mul(step, -lr))
    return (dict(zip(keys, new)),
            AdamState(mu=dict(zip(keys, mu)), nu=dict(zip(keys, nu)), count=count))


@torch.no_grad()
def adam_step(params: dict, grads: list, opt: AdamState, hp: HParams):
    """The PPO update's optimizer: global-norm clip to ``hp.max_grad_norm``,
    then :func:`adam_update` at ``hp.learning_rate``."""
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = torch.clamp(hp.max_grad_norm / (g_norm + 1e-6), max=1.0)
    return adam_update(params, torch._foreach_mul(grads, clip), opt, hp.learning_rate)


def sync_statistics(mesh, ts: TrainState, norm: nrm.NormalizerState, stat_r, stat_c):
    """The rollout's end-of-update sync over ``mesh``'s W ranks, one
    all-reduce (the JAX package's ``ppo.py:340-356``): the obs and return
    normalizers' ``mean`` and ``var`` are averaged over the ranks; their
    ``count`` and the episode counters ``stat_return`` / ``stat_count``
    become the update's old value plus the sum of every rank's increment,
    computed as ``sum(new) - (W - 1) * old`` so that one rank keeps its own
    value bit for bit.  -> (normalizer, stat_return, stat_count)."""
    old, w = ts.normalizer, mesh.world_size
    o, r = norm.obs_rms, norm.ret_rms
    summed = mesh.sum([o.mean, o.var, r.mean, r.var, o.count, r.count, stat_r, stat_c])
    o_mean, o_var, r_mean, r_var = (x / w for x in summed[:4])
    olds = (old.obs_rms.count, old.ret_rms.count, ts.stat_return, ts.stat_count)
    o_count, r_count, stat_r, stat_c = (s - (w - 1) * x for s, x in zip(summed[4:], olds))
    norm = norm.replace(obs_rms=o.replace(mean=o_mean, var=o_var, count=o_count),
                        ret_rms=r.replace(mean=r_mean, var=r_var, count=r_count))
    return norm, stat_r, stat_c


class PPO:
    """Holds the env and the network; :meth:`train_step` advances a
    :class:`TrainState`.

    Runs on ``device`` (default ``cuda``; with no CUDA and no device named,
    this raises), or on the device of ``env`` when one is given (e.g. an
    image env with another pipeline); by default the env is built from
    ``cfg``: ``make(...)`` for ``policy='mlp'``, ``DeviceImageVectorEnv``
    (the default image pipeline) for ``'cnn'``.  Matmuls keep PyTorch's default float32 precision (TF32
    off, ``torch.get_float32_matmul_precision() == 'highest'``), so that the
    card's actions match the CPU's."""

    def __init__(self, cfg: PPOConfig, device=None, env=None):
        self.cfg = cfg
        if env is None and cfg.policy == "cnn":
            # the JAX package's image env ignores max_episode_steps
            # (ppo.py:190); the port refuses it rather than drop it silently
            if cfg.max_episode_steps is not None:
                raise ValueError("max_episode_steps is not supported with policy='cnn': the "
                                 "image env keeps the registered episode limit")
            env = DeviceImageVectorEnv(cfg.env_id, num_envs=cfg.n_envs, backend=cfg.env_backend,
                                       velocity_iters=cfg.velocity_iters,
                                       position_iters=cfg.position_iters,
                                       device=resolve_device(device))
        elif env is None:
            if cfg.policy != "mlp":
                raise ValueError(f"policy must be 'mlp' or 'cnn', got {cfg.policy!r}")
            # make() rejects an unknown env_backend
            env = make(cfg.env_id, num_envs=cfg.n_envs, backend=cfg.env_backend,
                       velocity_iters=cfg.velocity_iters, position_iters=cfg.position_iters,
                       max_episode_steps=cfg.max_episode_steps, device=resolve_device(device))
        self.env = env
        self.device = env.device
        self.obs_dim, self.act_dim = env.cfg.obs_dim, env.cfg.act_dim
        # image envs expose obs_shape (stacked uint8 frames); flat envs don't
        self.obs_shape = getattr(env, "obs_shape", None)
        # obs normalization for flat obs only (SB3 image runs use
        # norm_obs=False); the reward is normalized either way
        self.use_obs_norm = cfg.normalize and self.obs_shape is None
        # the architecture; a TrainState's params are applied through it
        self.net = self.build_net(torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self.default_env_params = env.default_params()
        self.env_params = (
            self.default_env_params.set_reward_params(**dict(cfg.reward_params))
            if cfg.reward_params else self.default_env_params
        )

    def build_net(self, generator: torch.Generator):
        """A fresh network on the CPU, its init drawn from ``generator``."""
        if self.obs_shape is not None:
            return CnnActorCritic(self.obs_shape, self.act_dim, generator=generator)
        return ActorCritic(self.obs_dim, self.act_dim, self.cfg.net_arch, generator)

    # ------------------------------------------------------------------
    def init_state(self, seed: int | None = None) -> TrainState:
        """Fresh params (orthogonal init drawn on the CPU, so that every
        device starts from the same weights), Adam state, normalizer and env
        batch.  The net, the env and the learner's generator get three seeds
        derived from ``seed`` (default ``cfg.seed``)."""
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        net_seed, env_seed, run_seed = (int(s) for s in
                                        np.random.SeedSequence(seed).generate_state(3))
        net = self.build_net(torch.Generator().manual_seed(net_seed))
        params = {k: v.detach().to(self.device) for k, v in net.state_dict().items()}
        vstate, obs = self.env.reset(seed=env_seed, params=self.env_params)
        dev, E = self.device, cfg.n_envs
        zeros = lambda dtype: torch.zeros((E,), dtype=dtype, device=dev)  # noqa: E731
        scalar = lambda v, dtype: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
        return TrainState(
            params=params,
            opt_state=AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                                nu={k: torch.zeros_like(v) for k, v in params.items()},
                                count=0),
            normalizer=nrm.NormalizerState.create(self.obs_dim, E, _f32(cfg.gamma), dev),
            vstate=vstate,
            last_obs=obs,
            generator=torch.Generator(device=dev).manual_seed(run_seed),
            env_generator=self.env.generator,
            timesteps=scalar(0, torch.int64),
            ep_return=zeros(torch.float32),
            ep_len=zeros(torch.int32),
            stat_return=scalar(0.0, torch.float32),
            stat_count=scalar(0.0, torch.float32),
            env_params=self.env_params,
            hparams=HParams.from_config(cfg),
            image_pipeline=self.env.image_pipeline if self.obs_shape is not None else None,
        )

    def apply(self, params: dict, obs):
        """The network on ``obs`` with ``params`` -> (mean, log_std, value)."""
        return functional_call(self.net, params, (obs,))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def rollout(self, ts: TrainState, noise=None, timer=_untimed, mesh=None):
        """``n_steps`` env steps -> (ts with the env, normalizer and episode
        statistics advanced, Transition, bootstrap value [E]).

        ``noise`` [n_steps, n_envs, act_dim] is the standard normal action
        noise (default: drawn from ``ts.generator``).  The action is ``mean +
        exp(log_std) * noise``; the transition keeps it unclipped with its
        log-prob, and the env steps with it clipped to [-1, 1].  The
        bootstrap value is taken on the last obs normalized with the
        end-of-rollout statistics, without updating them.  With a ``mesh``
        those statistics and the episode counters are synced first
        (:func:`sync_statistics`)."""
        cfg, dev = self.cfg, self.device
        T, E = cfg.n_steps, cfg.n_envs
        if noise is None:
            noise = torch.randn((T, E, self.act_dim), generator=ts.generator, device=dev)
        # frames stay uint8: 4x smaller than float32
        obs_shape, obs_dtype = (((self.obs_dim,), torch.float32) if self.obs_shape is None
                                else (self.obs_shape, torch.uint8))
        traj = Transition(
            obs=torch.empty((T, E) + tuple(obs_shape), dtype=obs_dtype, device=dev),
            action=torch.empty((T, E, self.act_dim), device=dev),
            log_prob=torch.empty((T, E), device=dev),
            value=torch.empty((T, E), device=dev),
            reward=torch.empty((T, E), device=dev),
            done=torch.empty((T, E), dtype=torch.bool, device=dev),
            status=torch.empty((T, E), dtype=torch.int32, device=dev),
        )
        norm, vstate, obs = ts.normalizer, ts.vstate, ts.last_obs
        ep_ret, ep_len = ts.ep_return, ts.ep_len
        stat_r, stat_c = ts.stat_return, ts.stat_count
        for t in range(T):
            with timer("policy"):
                if self.use_obs_norm:
                    norm, n_obs = nrm.normalize_obs(norm, obs, update=True)
                else:
                    n_obs = obs
                mean, log_std, value = self.apply(ts.params, n_obs)
                action = mean + torch.exp(log_std) * noise[t]
                traj.obs[t], traj.action[t], traj.value[t] = n_obs, action, value
                traj.log_prob[t] = gaussian_log_prob(mean, log_std, action)
            clipped = torch.clamp(action, -1.0, 1.0)
            if self.obs_shape is None:
                with timer("env"):
                    vstate, obs, reward, done, info = self.env.step(vstate, clipped,
                                                                    ts.env_params)
            else:  # the image env times its physics ("env") and "render"
                vstate, obs, reward, done, info = self.env.step(vstate, clipped, ts.env_params,
                                                                timer=timer)
            with timer("env"):
                if cfg.normalize:
                    norm, n_reward = nrm.normalize_reward(norm, reward, done, update=True)
                else:
                    n_reward = reward
                ep_ret = ep_ret + reward
                ep_len = ep_len + 1
                stat_r = stat_r + torch.where(done, ep_ret, 0.0).sum()
                stat_c = stat_c + done.sum()
                ep_ret = torch.where(done, 0.0, ep_ret)
                ep_len = torch.where(done, 0, ep_len)
                traj.reward[t], traj.done[t], traj.status[t] = n_reward, done, info["done_status"]
        if mesh is not None:
            norm, stat_r, stat_c = sync_statistics(mesh, ts, norm, stat_r, stat_c)
        with timer("policy"):
            n_last = (nrm.normalize_obs(norm, obs, update=False)[1] if self.use_obs_norm
                      else obs)
            last_value = self.apply(ts.params, n_last)[2]
        ts = ts.replace(normalizer=norm, vstate=vstate, last_obs=obs, ep_return=ep_ret,
                        ep_len=ep_len, stat_return=stat_r, stat_count=stat_c)
        return ts, traj, last_value

    def loss(self, params: dict, obs, action, old_log_prob, advantages, returns, hp: HParams):
        """Clipped surrogate + value MSE - entropy bonus on one minibatch ->
        (total, (policy_loss, value_loss, entropy, approx_kl)).  Advantages
        are normalized per minibatch with their population std."""
        mean, log_std, value = self.apply(params, obs)
        log_prob = gaussian_log_prob(mean, log_std, action)
        ratio = torch.exp(log_prob - old_log_prob)
        a = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
        lo = _f32(np.float32(1.0) - np.float32(hp.clip_range))
        hi = _f32(np.float32(1.0) + np.float32(hp.clip_range))
        pg_loss = -torch.minimum(a * ratio, a * torch.clamp(ratio, lo, hi)).mean()
        v_loss = ((returns - value) ** 2).mean()
        ent = gaussian_entropy(log_std)
        total = pg_loss + hp.vf_coef * v_loss - hp.ent_coef * ent
        with torch.no_grad():
            approx_kl = ((ratio - 1.0) - torch.log(ratio)).mean()
        return total, (pg_loss.detach(), v_loss.detach(), ent.detach(), approx_kl)

    def update(self, ts: TrainState, traj: Transition, advantages, returns, perms=None,
               mesh=None):
        """``n_epochs`` passes of minibatch SGD -> (ts with params and Adam
        state advanced, metrics).

        ``perms`` [n_epochs, n_steps * n_envs] is the minibatch order of each
        epoch (default: ``torch.randperm`` from ``ts.generator``, all drawn
        first); each epoch takes ``n_minibatch = total // mb_size``
        minibatches of ``mb_size = min(batch_size, total)`` from the front
        of its permutation.

        Target-KL stop (the JAX package's, not SB3's): the minibatch whose
        approx KL exceeds ``1.5 * target_kl`` still applies its update, and
        every later minibatch of the update is skipped; ``target_kl <= 0``
        disables it.  ``approx_kl`` is the KL of the last applied minibatch.
        The JAX package runs the skipped minibatches frozen and averages
        their losses too; here ``loss``, ``policy_loss``, ``value_loss`` and
        ``entropy`` average the minibatches that ran.  The stop reads each
        minibatch's KL on the host.

        With a ``mesh`` of W ranks each rank takes minibatches of
        ``batch_size // W`` of its own transitions (advantages normalized
        within them); the gradients and the KL are averaged over the ranks in
        one all-reduce per minibatch, before the clip and the KL test, so that
        every rank applies the same step and stops at the same minibatch; the
        four losses are averaged over the ranks at the end."""
        cfg, hp = self.cfg, ts.hparams
        world = 1 if mesh is None else mesh.world_size
        total = traj.done.numel()
        flat = lambda x: x.reshape((total,) + x.shape[2:])  # noqa: E731
        obs, action, old_lp = flat(traj.obs), flat(traj.action), flat(traj.log_prob)
        adv, ret = flat(advantages), flat(returns)
        mb_size = max(1, min(cfg.batch_size // world, total))
        n_minibatch = max(1, total // mb_size)
        if perms is None:
            perms = torch.stack([torch.randperm(total, generator=ts.generator, device=self.device)
                                 for _ in range(cfg.n_epochs)])
        kl_limit = (float(np.float32(1.5) * np.float32(hp.target_kl))
                    if hp.target_kl > 0.0 else None)
        params = {k: v.detach().requires_grad_() for k, v in ts.params.items()}
        opt = ts.opt_state
        stats, kl_last, stopped = [], torch.zeros((), device=self.device), False
        for epoch in range(cfg.n_epochs):
            for idx in perms[epoch, : n_minibatch * mb_size].view(n_minibatch, mb_size):
                loss, (pg, vl, ent, kl) = self.loss(params, obs[idx], action[idx], old_lp[idx],
                                                   adv[idx], ret[idx], hp)
                grads = list(torch.autograd.grad(loss, list(params.values())))
                if mesh is not None:
                    *grads, kl = mesh.mean(grads + [kl])
                params, opt = adam_step(params, grads, opt, hp)
                params = {k: v.requires_grad_() for k, v in params.items()}
                stats.append(torch.stack([loss.detach(), pg, vl, ent]))
                kl_last = kl
                if kl_limit is not None and kl.item() > kl_limit:
                    stopped = True
                    break
            if stopped:
                break
        means = torch.stack(stats).mean(dim=0)
        if mesh is not None:
            (means,) = mesh.mean([means])
        metrics = {"loss": means[0], "policy_loss": means[1], "value_loss": means[2],
                   "entropy": means[3], "approx_kl": kl_last, "kl_stopped": stopped}
        ts = ts.replace(params={k: v.detach() for k, v in params.items()}, opt_state=opt)
        return ts, metrics

    def train_step(self, ts: TrainState, noise=None, perms=None, timer=_untimed, mesh=None):
        """One update: rollout, GAE, epochs -> (ts, metrics).  ``metrics``
        holds tensors on the device (``kl_stopped`` a bool): ``ep_rew_mean``
        (NaN when no episode finished), ``episodes``, ``completions`` (steps
        whose ``done_status`` is 3), ``timesteps`` (int64) and the losses.
        ``timer`` (a :class:`PhaseTimer`) splits the update into ``env``
        (physics and the reward bookkeeping), ``render`` (image env only),
        ``policy``, ``gae`` and ``update``.  With a ``mesh`` the episode
        statistics, ``completions`` and ``timesteps`` count every rank's
        envs."""
        ts0 = ts
        ts, traj, last_value = self.rollout(ts, noise, timer, mesh)
        with timer("gae"):
            advantages, returns = compute_gae(traj, last_value, ts.hparams.gamma,
                                              ts.hparams.gae_lambda)
        with timer("update"):
            ts, metrics = self.update(ts, traj, advantages, returns, perms, mesh)
        completed = ts.stat_count - ts0.stat_count
        mean_ret = torch.where(completed > 0, (ts.stat_return - ts0.stat_return)
                               / torch.clamp_min(completed, 1.0), float("nan"))
        completions = (traj.status == 3).sum()
        world = 1
        if mesh is not None:
            (completions,), world = mesh.sum([completions]), mesh.world_size
        ts = ts.replace(timesteps=ts0.timesteps + traj.done.numel() * world)
        metrics.update(ep_rew_mean=mean_ret, episodes=completed,
                       completions=completions, timesteps=ts.timesteps)
        return ts, metrics

    # ------------------------------------------------------------------
    def apply_curriculum(self, ts: TrainState, update: int, n_updates: int) -> TrainState:
        """The reference trainer's per-epoch hooks (SURVEY §3.3): anneal the
        reward-weight overrides, decay the shaped rewards (``update_params``,
        02.py:227-230), shrink the goal epsilon (``update_goal``,
        00.py:245-246) and anneal the learning rate, as the JAX package does."""
        cfg = self.cfg
        p = ts.env_params
        if cfg.reward_anneal_updates and cfg.reward_params:
            frac = min(1.0, update / max(1, cfg.reward_anneal_updates))
            fields = {RewardParams.REFERENCE_WEIGHT_NAMES.get(k, k) for k, _ in cfg.reward_params}
            for base, shaped in (
                ("out_of_bounds_penalty", "shaped_bounds_penalty"),
                ("blk_out_of_bounds_penalty", "shaped_blk_bounds_penalty"),
                ("puzzle_complete_reward", "shaped_puzzle_reward"),
            ):
                if base in fields:
                    fields.add(shaped)
            p = p.replace(**{
                f: _f32((1.0 - frac) * float(getattr(self.env_params, f))
                        + frac * float(getattr(self.default_env_params, f)))
                for f in fields})
        if cfg.update_params_decay is not None:
            p = p.update_params(int(ts.timesteps), cfg.update_params_decay)
        if cfg.update_goal:
            p = p.update_goal(update, max(1, n_updates), self.env_params.scaled_epsilon)
        ts = ts.replace(env_params=p)
        if cfg.anneal_lr:
            frac = 1.0 - update / max(1, n_updates)
            ts = ts.replace(hparams=ts.hparams.replace(
                learning_rate=_f32(np.float32(ts.hparams.lr_base) * np.float32(frac))))
        return ts

    def set_reward_params(self, ts: TrainState, **kw) -> TrainState:
        """The reference's ``env.set_reward_params`` (00.py:231-239) on a live
        TrainState, by its kwarg names (agentDelta, agentDistance,
        blockDelta, blockDistance, puzzleComp, outOfBounds, blkOutOfBounds)."""
        return ts.replace(env_params=ts.env_params.set_reward_params(**kw))

    def set_hparams(self, ts: TrainState, **kw) -> TrainState:
        """Change optimization knobs (see :class:`HParams`) on a live
        TrainState.  Setting ``learning_rate`` also re-anchors ``lr_base``;
        ``target_kl=0`` disables the KL stop; ``gamma`` also rewrites the
        reward normalizer's discount."""
        kw = {k: _f32(v) for k, v in kw.items()}
        if "learning_rate" in kw and "lr_base" not in kw:
            kw["lr_base"] = kw["learning_rate"]
        ts = ts.replace(hparams=ts.hparams.replace(**kw))
        if "gamma" in kw:
            ts = ts.replace(normalizer=ts.normalizer.replace(gamma=kw["gamma"]))
        return ts

    def learn(self, total_timesteps=None, log_fn=None, state=None,
              checkpoint_fn=None, checkpoint_every: int = 0, mesh=None) -> TrainState:
        """``total_timesteps // (n_steps * n_envs * W)`` updates (at least
        one), W the ranks of ``mesh`` (1 without).  ``log_fn(update,
        metrics)`` gets the metrics as Python numbers; ``checkpoint_fn(update,
        ts)`` fires every ``checkpoint_every`` updates (0 = only the caller's
        final save)."""
        cfg = self.cfg
        total = total_timesteps or cfg.total_timesteps
        ts = self.init_state() if state is None else state
        world = 1 if mesh is None else mesh.world_size
        n_updates = max(1, total // (cfg.n_steps * cfg.n_envs * world))
        for u in range(n_updates):
            ts = self.apply_curriculum(ts, u, n_updates)
            ts, metrics = self.train_step(ts, mesh=mesh)
            if log_fn is not None:
                log_fn(u, {k: v.item() if isinstance(v, torch.Tensor) else v
                           for k, v in metrics.items()})
            if (checkpoint_fn is not None and checkpoint_every > 0
                    and u and u % checkpoint_every == 0):
                checkpoint_fn(u, ts)
        return ts
