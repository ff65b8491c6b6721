"""Data parallelism over processes (port of ``gym_puzzles_tpu/parallel/``):
:class:`DistributedPPO` on ``torch.distributed``, the collective heartbeat and
the weak-scaling bench (``python -m gym_puzzles_tpu_torch.parallel.scaling_bench``)."""

from gym_puzzles_tpu_torch.parallel.health import Heartbeat, HeartbeatTimeout
from gym_puzzles_tpu_torch.parallel.mesh import (
    DistributedPPO,
    Mesh,
    init_distributed,
    make_mesh,
    train_state_specs,
)

__all__ = ["DistributedPPO", "Heartbeat", "HeartbeatTimeout", "Mesh", "init_distributed",
           "make_mesh", "train_state_specs"]
