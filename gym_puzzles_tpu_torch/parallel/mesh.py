"""Data parallelism over processes: the env batch split over ranks, the
learner replicated, collectives through ``torch.distributed`` (port of
``gym_puzzles_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh (``shard_map``).  The
port runs one process per GPU instead -- rank r on ``cuda:LOCAL_RANK``,
started by ``torchrun`` -- each with an ordinary :class:`PPO` over
``n_envs / world_size`` envs, and syncs at the JAX step's points (see
``train/ppo.py``): the normalizer and episode statistics once per update,
the gradients and the KL in one all-reduce per minibatch, the losses and
completions at the end.  The all-reduce is NCCL's on the card and gloo's on
the CPU.

Randomness: params come from the same CPU-drawn init on every rank; the env
batch is each rank's slice of the batch a single-process
``PPO(cfg).init_state()`` builds.  Rank 0 keeps that learner's two
generators; rank r > 0 seeds its env generator (spawns) and its learner
generator (action noise, minibatch order) from ``cfg.seed`` with r as the
spawn key.  Each generator is the rank's own, so the JAX package's
replicated master key has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from gym_puzzles_tpu_torch.api.vector import resolve_device
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig, TrainState, _untimed

# TrainState fields that each rank holds for its own envs (dotted: a field
# of the normalizer); every other field is replicated
SHARDED = ("vstate", "last_obs", "ep_return", "ep_len", "normalizer.returns", "generator",
           "env_generator")


def local_device(device=None) -> torch.device:
    """The learner's device: ``device`` when named, else ``cuda:LOCAL_RANK``
    (torchrun's variable, 0 without it).  With no device named and no CUDA
    this raises."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(init_method=None, world_size=None, rank=None, backend=None, device=None):
    """Join the process group.  Does nothing with one process.

    ``world_size`` and ``rank`` default to torchrun's ``WORLD_SIZE`` and
    ``RANK``, ``init_method`` to ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``); ``backend`` to ``nccl`` when the learner's device
    (:func:`local_device` of ``device``) is CUDA, else ``gloo``.  The CUDA
    device is made the process's current one."""
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if world_size <= 1:
        return
    rank = int(os.environ["RANK"]) if rank is None else rank
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method or "env://", world_size=world_size,
                            rank=rank)


@dataclasses.dataclass
class Mesh:
    """The ranks a learner syncs over: the process group (None for one
    process with no group), this process's rank and the world size.

    :meth:`sum` and :meth:`mean` reduce a list of tensors of one dtype in one
    all-reduce (flattened into one buffer).  A CUDA buffer on a gloo group is
    staged through the host; that is for a caller who chose gloo (e.g. two
    ranks sharing one card, which NCCL refuses), never a fallback from NCCL.
    ``calls`` counts the all-reduces."""

    group: object
    rank: int
    world_size: int
    backend: str | None
    calls: int = 0

    def sum(self, tensors: list) -> list:
        self.calls += 1
        if self.backend is None:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if self.backend == "gloo" and flat.is_cuda:
            host = flat.cpu()
            dist.all_reduce(host, group=self.group)
            flat.copy_(host)
        else:
            dist.all_reduce(flat, group=self.group)
        return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def mean(self, tensors: list) -> list:
        return [t / self.world_size for t in self.sum(tensors)]

    def barrier(self):
        if self.backend is not None:
            dist.barrier(group=self.group)


def make_mesh(group=None) -> Mesh:
    """The :class:`Mesh` of ``group`` (default: the whole job), or of this
    process alone when no process group was initialized."""
    if not dist.is_initialized():
        return Mesh(group=None, rank=0, world_size=1, backend=None)
    return Mesh(group=group, rank=dist.get_rank(group), world_size=dist.get_world_size(group),
                backend=dist.get_backend(group))


def train_state_specs(ts: TrainState) -> dict:
    """Every field of a :class:`TrainState` (the normalizer's as
    ``normalizer.<field>``) -> True where each rank holds its own shard (its
    envs' state, obs and episode counters, the normalizer's running returns,
    both generators), False where the field is replicated (params, Adam
    state, normalizer moments and counts, statistics, timesteps, env params,
    hparams).  Checkpoints write the replicated part once and a file per
    rank."""
    specs = {}
    for f in dataclasses.fields(ts):
        if f.name == "normalizer":
            for g in dataclasses.fields(ts.normalizer):
                specs[f"normalizer.{g.name}"] = f"normalizer.{g.name}" in SHARDED
        else:
            specs[f.name] = f.name in SHARDED
    return specs


def _env_slice(x, sl):
    """The envs ``sl`` of an env state (env axis last on every leaf), as
    contiguous copies."""
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _env_slice(getattr(x, f.name), sl)
                          for f in dataclasses.fields(x)})
    return x[..., sl].clone(memory_format=torch.contiguous_format)


class DistributedPPO:
    """PPO over the ranks of a process group, each on its own device with
    ``n_envs / world_size`` envs.

    Usage, one process per GPU (``torchrun --nproc_per_node N``)::

        init_distributed()
        algo = DistributedPPO(PPOConfig(env_id=..., n_envs=4096))
        ts = algo.init_state()          # this rank's share of the env batch
        ts, metrics = algo.train_step(ts)

    ``device`` defaults to ``cuda:LOCAL_RANK`` (with no CUDA and none named,
    this raises); ``group`` to the whole job, or this process alone when no
    group was initialized.  ``policy='mlp'`` only."""

    def __init__(self, cfg: PPOConfig, device=None, group=None):
        self.mesh = make_mesh(group)
        world = self.mesh.world_size
        if cfg.n_envs % world:
            raise ValueError(f"n_envs={cfg.n_envs} must divide over {world} ranks")
        if cfg.policy != "mlp":
            raise ValueError(f"DistributedPPO trains policy='mlp', got {cfg.policy!r}")
        self.cfg = cfg
        self.device = local_device(device)
        self.ppo = PPO(dataclasses.replace(cfg, n_envs=cfg.n_envs // world), device=self.device)

    def init_state(self, seed: int | None = None) -> TrainState:
        """This rank's TrainState: the replicated fields and its slice of
        the envs as a single-process ``PPO(cfg).init_state(seed)`` builds
        them, with this rank's generators (module docstring)."""
        seed = self.cfg.seed if seed is None else seed
        full = PPO(self.cfg, device=self.device).init_state(seed)
        rank, n = self.mesh.rank, self.ppo.cfg.n_envs
        sl = slice(rank * n, (rank + 1) * n)
        env_gen, gen = self.ppo.env.generator, full.generator
        env_gen.set_state(full.env_generator.get_state())
        if rank:
            env_seed, run_seed = np.random.SeedSequence(seed, spawn_key=(rank,)).generate_state(2)
            env_gen.manual_seed(int(env_seed))
            gen = torch.Generator(device=self.device).manual_seed(int(run_seed))
        take = lambda x: x[sl].clone()  # noqa: E731
        return full.replace(
            vstate=_env_slice(full.vstate, sl), last_obs=take(full.last_obs),
            ep_return=take(full.ep_return), ep_len=take(full.ep_len),
            normalizer=full.normalizer.replace(returns=take(full.normalizer.returns)),
            generator=gen, env_generator=env_gen)

    def train_step(self, ts: TrainState, noise=None, perms=None, timer=_untimed):
        """One update of every rank (``PPO.train_step`` over the mesh);
        ``noise`` and ``perms`` are this rank's."""
        return self.ppo.train_step(ts, noise, perms, timer, mesh=self.mesh)

    def set_hparams(self, ts: TrainState, **kw) -> TrainState:
        return self.ppo.set_hparams(ts, **kw)

    def learn(self, total_timesteps=None, log_fn=None, state=None, checkpoint_fn=None,
              checkpoint_every: int = 0) -> TrainState:
        """``PPO.learn`` over the mesh: ``total_timesteps`` counts every
        rank's env steps."""
        return self.ppo.learn(total_timesteps, log_fn,
                              self.init_state() if state is None else state,
                              checkpoint_fn, checkpoint_every, mesh=self.mesh)
