"""Rank process of ``tests/test_torch_multiprocess.py::test_recovery_restart_from_checkpoint``:
the recovery contract of ``parallel/health.py`` with the port's
``DistributedPPO`` on two gloo ranks (``file://`` rendezvous).

* ``fail``: train 2 updates, save a sharded checkpoint (every rank calls
  ``checkpoint.save`` with its mesh), then rank 1 stalls silently (until rank
  0 has reported, at most 30 s); rank 0's heartbeat must raise
  ``HeartbeatTimeout`` and it exits as a poisoned process does.
* ``recover``: a fresh job trains 3 updates straight (the control), then
  restores the checkpoint into a fresh state and trains 1 update; each rank
  prints whether its whole state (params, Adam state, normalizer, its envs
  and generators, counters) equals the control's bit for bit, and a checksum
  of the params for the two ranks to agree on.

Usage: python tests/_torch_mp_recovery_worker.py <phase> <rank> <world> <rendezvous> <ckpt_dir>
"""

import json
import os
import pathlib
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gym_puzzles_tpu_torch.parallel import (  # noqa: E402
    DistributedPPO,
    Heartbeat,
    HeartbeatTimeout,
    init_distributed,
)
from gym_puzzles_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from gym_puzzles_tpu_torch.train.ppo import PPOConfig  # noqa: E402

torch.set_num_threads(1)
phase, rank, world, rendezvous, ckpt_dir = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                            sys.argv[4], sys.argv[5])
init_distributed(init_method=f"file://{rendezvous}", world_size=world, rank=rank, device="cpu")
algo = DistributedPPO(PPOConfig(n_envs=4, n_steps=4, batch_size=8, n_epochs=1,
                                velocity_iters=4, position_iters=2, seed=0), device="cpu")


def differing(a, b, path=""):
    if isinstance(a, dict):
        return [p for k in a for p in differing(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, torch.Tensor):
        return [] if a.dtype == b.dtype and torch.equal(a, b) else [path]
    return [] if a == b else [path]


if phase == "fail":
    hb = Heartbeat(timeout=60.0)
    ts = algo.init_state()
    for _ in range(2):
        ts, _m = algo.train_step(ts)
    ckpt.save(ckpt_dir, ts, ckpt.step_count(ts.timesteps), mesh=algo.mesh)
    print("SAVED", flush=True)
    marker = pathlib.Path(ckpt_dir) / "rank0_reported"
    if rank == 1:
        t0 = time.monotonic()
        while not marker.exists() and time.monotonic() - t0 < 30.0:
            time.sleep(0.1)
        print("STALLER_EXITING", flush=True)
        os._exit(0)
    hb.timeout = 3.0
    try:
        hb.ping()
        print("NO_TIMEOUT", flush=True)
    except HeartbeatTimeout:
        print("TIMEOUT_RAISED", flush=True)
        marker.touch()
        os._exit(0)

elif phase == "recover":
    ts = algo.init_state()
    for _ in range(3):
        ts, _m = algo.train_step(ts)
    control = ckpt.to_tree(ts)  # generator states copied before the restore resets them
    rs = ckpt.restore(ckpt_dir, algo.init_state(), mesh=algo.mesh)
    rs, _m = algo.train_step(rs)
    diff = differing(ckpt.to_tree(rs), control)
    params_sum = float(sum(v.double().abs().sum() for v in rs.params.values()))
    print("RESULT " + json.dumps({"rank": rank, "differs": diff, "params_sum": params_sum}),
          flush=True)

else:
    raise SystemExit(f"unknown phase {phase}")
