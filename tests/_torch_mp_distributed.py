"""Rank processes of ``tests/test_torch_distributed.py``: each rank builds
the port's ``DistributedPPO`` over a gloo group (``file://`` rendezvous),
records its initial shard and generators, then runs one update from the JAX
oracle's shard of the start state with its own action noise and minibatch
order, once per case, and writes what it got to ``<out>/rank<r>.pt``.

Started by ``torch.multiprocessing.start_processes(run_rank, ...)``; imports
neither JAX nor the JAX package.
"""

import torch
import torch.distributed as dist

from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.parallel import DistributedPPO
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train.ppo import PPOConfig


def run_rank(rank, world, cfg_kw, cases, rendezvous, out):
    """``cases``: name -> (hparams, start, noise [W, E_local, act], perm [W,
    T * E_local]); ``start`` holds the JAX state's replicated params and
    normalizer moments and the per-rank ``vstate`` / ``last_obs`` /
    ``returns`` shards as numpy."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", world_size=world,
                            rank=rank)
    try:
        cfg = PPOConfig(**cfg_kw)
        try:
            DistributedPPO(PPOConfig(**dict(cfg_kw, n_envs=world + 1)), device="cpu")
            refused = None
        except ValueError as e:
            refused = str(e)
        algo = DistributedPPO(cfg, device="cpu")
        ts0 = algo.init_state()
        draw = torch.Generator().set_state(ts0.generator.get_state())
        got = {"init": ckpt.to_tree(ts0),
               "noise": torch.randn((cfg.n_envs // world, 6), generator=draw),
               "refused": refused}
        T, E = cfg.n_steps, cfg.n_envs // world
        for name, (hp, start, noise, perm) in cases.items():
            ts = ts0.replace(
                params=convert.actor_critic_from_numpy(start["params"]).state_dict(),
                vstate=convert.state_from_numpy(start["vstate"][rank]),
                last_obs=torch.tensor(start["last_obs"][rank]),
                normalizer=convert.normalizer_from_numpy(
                    dict(start["normalizer"], returns=start["returns"][rank])))
            ts = algo.set_hparams(ts, **hp)
            calls = algo.mesh.calls
            ts, metrics = algo.train_step(
                ts, noise=torch.from_numpy(noise[rank]).expand(T, E, 6),
                perms=torch.from_numpy(perm[rank]).expand(cfg.n_epochs, T * E))
            got[name] = {"state": ckpt.to_tree(ts), "metrics": ckpt.to_tree(metrics),
                         "collectives": algo.mesh.calls - calls}
        torch.save(got, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
