"""Weak-scaling benchmark: env-steps/s at 1..N ranks, envs per rank held
constant (port of ``gym_puzzles_tpu/parallel/scaling_bench.py``).

The env batch is embarrassingly parallel (no cross-env interaction), so the
per-update communication is the learner's: one all-reduce of the gradients
and the KL per minibatch, plus the statistics once per update.  This harness
measures that overhead by timing :class:`DistributedPPO` updates (rollout,
GAE, minibatch SGD, all-reduces) at growing world sizes: one job per world
size 1, 2, 4, ... up to ``--nproc`` (default: the visible GPUs), one process
per device, rank r on ``cuda:r`` (NCCL), or on the CPU with ``--device cpu``
(gloo).

Usage::

    python -m gym_puzzles_tpu_torch.parallel.scaling_bench \\
        [--env MultiRobotPuzzle-v0] [--envs-per-device 2048] [--n-steps 64] \\
        [--updates 3] [--nproc N] [--device cpu]

On a one-GPU machine this is the n = 1 row.  Each row prints one JSON line::

    {"metric": "scaling", "devices": n, "env_steps_per_s": r,
     "per_device": r/n, "efficiency_vs_1dev": e}
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gym_puzzles_tpu_torch.api.vector import resolve_device
from gym_puzzles_tpu_torch.parallel.mesh import DistributedPPO
from gym_puzzles_tpu_torch.train.ppo import PPOConfig


def measure(algo: DistributedPPO, updates: int = 3) -> float:
    """Best env-steps/s (every rank's steps) over ``updates`` timed updates
    after a warm one."""
    cfg = algo.cfg
    ts, metrics = algo.train_step(algo.init_state())  # warm: first use of every kernel
    metrics["timesteps"].item()
    per_update = cfg.n_steps * cfg.n_envs
    best = 0.0
    for _ in range(updates):
        algo.mesh.barrier()
        t0 = time.perf_counter()
        ts, metrics = algo.train_step(ts)
        metrics["timesteps"].item()  # waits for the update
        best = max(best, per_update / (time.perf_counter() - t0))
    return best


def _rank_main(rank, world, cfg, updates, device, rendezvous, out):
    """One rank of a world-size-``world`` job; rank 0 writes the rate."""
    if device == "cpu":
        torch.set_num_threads(1)  # one core per rank
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{rendezvous}", world_size=world, rank=rank)
    try:
        rate = measure(DistributedPPO(cfg, device=dev), updates)
        if rank == 0:
            pathlib.Path(out).write_text(json.dumps(rate))
    finally:
        dist.destroy_process_group()


def world_sizes(nproc: int) -> list:
    """1, 2, 4, ... up to ``nproc``, and ``nproc`` itself."""
    sizes = [1]
    while sizes[-1] * 2 <= nproc:
        sizes.append(sizes[-1] * 2)
    return sizes if sizes[-1] == nproc else sizes + [nproc]


def run(env_id: str = "MultiRobotPuzzle-v0", envs_per_device: int = 2048, n_steps: int = 64,
        updates: int = 3, nproc: int | None = None, device: str | None = None,
        overrides: dict | None = None) -> list:
    """One job per world size -> the rows.  ``device='cpu'`` runs the ranks
    on the CPU over gloo, else rank r on ``cuda:r`` over NCCL (``nproc``
    defaults to 1 on the CPU, else to the visible GPUs; with no CUDA this
    raises); ``overrides`` are further PPOConfig fields (e.g. solver
    iterations)."""
    if nproc is None and device == "cpu":
        nproc = 1
    elif nproc is None:
        resolve_device(None)  # raises without CUDA
        nproc = torch.cuda.device_count()
    rows, base = [], None
    for n in world_sizes(nproc):
        cfg = PPOConfig(env_id=env_id, n_envs=envs_per_device * n, n_steps=n_steps,
                        batch_size=envs_per_device * n, n_epochs=2,
                        total_timesteps=n_steps * envs_per_device * n, **(overrides or {}))
        with tempfile.TemporaryDirectory() as tmp:
            out = pathlib.Path(tmp) / "rate.json"
            mp.start_processes(_rank_main, args=(n, cfg, updates, device, f"{tmp}/rdv",
                                                 str(out)),
                               nprocs=n, start_method="spawn")
            rate = json.loads(out.read_text())
        base = rate if base is None else base
        row = {"metric": "scaling", "devices": n, "env_steps_per_s": round(rate, 1),
               "per_device": round(rate / n, 1),
               "efficiency_vs_1dev": round(rate / (base * n), 4)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", default="MultiRobotPuzzle-v0")
    p.add_argument("--envs-per-device", type=int, default=2048)
    p.add_argument("--n-steps", type=int, default=64)
    p.add_argument("--updates", type=int, default=3)
    p.add_argument("--nproc", type=int, default=None,
                   help="largest world size (default: the visible GPUs; 1 with --device cpu)")
    p.add_argument("--device", default=None, choices=["cpu"],
                   help="run the ranks on the CPU over gloo (default: one GPU each)")
    args = p.parse_args()
    run(args.env, args.envs_per_device, args.n_steps, args.updates, args.nproc, args.device)


if __name__ == "__main__":
    main()
