"""Rank process of ``tests/test_torch_multiprocess.py::test_heartbeat_detects_stalled_rank``.

Both ranks join a gloo group (``file://`` rendezvous) and complete one
heartbeat round.  Then rank 1 stalls: it never pings again, and waits
(at most ``STALL_LIMIT`` seconds) until rank 0 has reported, so that the stall
is silent rather than a closed connection.  Rank 0 pings with a 3 s deadline
and must raise ``HeartbeatTimeout`` within it; then it exits at once, as a
poisoned process does.

Usage: python tests/_torch_mp_heartbeat_worker.py <rank> <world> <rendezvous file> <marker>
"""

import os
import pathlib
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gym_puzzles_tpu_torch.parallel import (  # noqa: E402
    Heartbeat,
    HeartbeatTimeout,
    init_distributed,
)

DEADLINE = 3.0
STALL_LIMIT = 30.0

torch.set_num_threads(1)
rank, world, rendezvous, marker = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
init_distributed(init_method=f"file://{rendezvous}", world_size=world, rank=rank, device="cpu")

hb = Heartbeat(timeout=60.0)
hb.ping()
print("PING_OK", flush=True)

if rank == 1:
    t0 = time.monotonic()
    while not pathlib.Path(marker).exists() and time.monotonic() - t0 < STALL_LIMIT:
        time.sleep(0.1)
    print("STALLER_EXITING", flush=True)
    os._exit(0)

hb.timeout = DEADLINE
t0 = time.monotonic()
try:
    hb.ping()
    print("NO_TIMEOUT", flush=True)
except HeartbeatTimeout:
    print(f"TIMEOUT_RAISED after {time.monotonic() - t0:.3f} s", flush=True)
    pathlib.Path(marker).touch()
    os._exit(0)
