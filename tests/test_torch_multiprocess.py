"""The port's multi-process paths on the CPU (counterpart of
``tests/test_multiprocess.py``): real OS processes on gloo, each rendezvous
through a file under the test's temporary directory (no fixed ports).

* a collective heartbeat whose rank 1 stalls: rank 0 raises
  ``HeartbeatTimeout`` within its deadline;
* the recovery contract: train 2, save, rank 1 stalls, rank 0 times out; a
  fresh job restores and trains 1, equal to a straight 3-update run bit for
  bit;
* the weak-scaling bench at world sizes 1 and 2;
* the trainer CLI with ``--distributed``: at world size 1 in this process
  (train, save, resume), and on two ranks under torchrun.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

from gym_puzzles_tpu_torch.parallel import scaling_bench
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train import cli

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
SMALL = ["--device", "cpu", "--velocity_iters", "4", "--position_iters", "2", "--n_steps", "4",
         "--batch_size", "8", "--n_epochs", "1", "--disable_wandb"]


def launch(script, args_of_rank, world=2, timeout=120):
    """Run ``world`` ranks of ``script`` -> [(returncode, stdout, stderr)]."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE / script), *args_of_rank(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=REPO, env=env)
             for rank in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    return outs


def test_heartbeat_detects_stalled_rank(tmp_path):
    outs = launch("_torch_mp_heartbeat_worker.py",
                  lambda r: [str(r), "2", str(tmp_path / "rdv"), str(tmp_path / "reported")])
    (rc0, out0, err0), (rc1, out1, err1) = outs
    assert "PING_OK" in out0 and "PING_OK" in out1, outs
    assert "STALLER_EXITING" in out1, (out1, err1)
    assert "NO_TIMEOUT" not in out0
    found = re.search(r"TIMEOUT_RAISED after ([0-9.]+) s", out0)
    assert found, f"rank 0 never timed out:\n{out0}\n{err0}"
    # raised at its 3 s deadline, not later
    assert 3.0 <= float(found.group(1)) < 5.0, out0
    assert rc0 == 0 and rc1 == 0, outs


def test_recovery_restart_from_checkpoint(tmp_path):
    ckpt_dir = tmp_path / "ckpt"

    def job(phase):
        return launch("_torch_mp_recovery_worker.py",
                      lambda r: [phase, str(r), "2", str(tmp_path / f"rdv_{phase}"), str(ckpt_dir)])

    (rc0, out0, err0), (rc1, out1, err1) = job("fail")
    assert "SAVED" in out0 and "SAVED" in out1, (out0, err0, out1, err1)
    assert "TIMEOUT_RAISED" in out0 and "NO_TIMEOUT" not in out0, (out0, err0)
    assert rc0 == 0 and rc1 == 0
    step = ckpt.latest_step(ckpt_dir)
    assert step == 2 * 4 * 4
    assert sorted(p.name for p in (ckpt_dir / str(step)).iterdir()) == [
        "shard_0.pt", "shard_1.pt", "state.pt"]

    results = []
    for rc, out, err in job("recover"):
        assert rc == 0, f"worker failed:\n{out}\n{err}"
        results += [json.loads(line[len("RESULT "):]) for line in out.splitlines()
                    if line.startswith("RESULT ")]
    assert [r["rank"] for r in results] == [0, 1]
    # restored and continued equals the uninterrupted run, bit for bit
    assert results[0]["differs"] == [] and results[1]["differs"] == [], results
    assert results[0]["params_sum"] == results[1]["params_sum"]


def test_scaling_bench_one_and_two_ranks():
    rows = scaling_bench.run(envs_per_device=2, n_steps=2, updates=1, nproc=2, device="cpu",
                             overrides=dict(velocity_iters=2, position_iters=1))
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["metric"] == "scaling" and r["env_steps_per_s"] > 0 for r in rows)
    assert rows[0]["efficiency_vs_1dev"] == 1.0
    assert abs(rows[1]["per_device"] - rows[1]["env_steps_per_s"] / 2) <= 0.1
    assert scaling_bench.world_sizes(6) == [1, 2, 4, 6]


def test_cli_distributed(tmp_path, capsys, monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    base = SMALL + ["--distributed", "--n_envs", "2", "--checkpoint_dir", str(tmp_path / "w1")]
    cli.main(base + ["--total_timesteps", "8", "--save_model"])
    path = tmp_path / "w1" / "MultiRobotPuzzle-v0"
    final = cli.main(base + ["--total_timesteps", "8", "--resume", str(path), "--save_model"])
    assert ckpt.step_count(final.timesteps) == 16
    out = capsys.readouterr().out
    assert "distributed: 1 rank(s), no process group" in out and "resumed from" in out
    assert sorted(p.name for p in (path / "16").iterdir()) == ["shard_0.pt", "state.pt"]

    # two ranks under torchrun: two updates, a periodic save after the
    # second, rank 0 alone prints
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "gym_puzzles_tpu_torch.train.cli", *SMALL, "--distributed", "--n_envs", "4",
         "--total_timesteps", "32", "--save_model", "--checkpoint_every", "1",
         "--checkpoint_dir", str(tmp_path / "w2")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr
    lines = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    assert [line["timesteps"] for line in lines] == [16, 32]
    assert run.stdout.count("config: ") == run.stdout.count("periodic checkpoint") == 1
    assert "distributed: 2 rank(s), gloo process group, 2 envs each on cpu" in run.stdout
    saved = tmp_path / "w2" / "MultiRobotPuzzle-v0"
    assert ckpt.latest_step(saved) == 32
    assert sorted(p.name for p in (saved / "32").iterdir()) == [
        "shard_0.pt", "shard_1.pt", "state.pt"]
