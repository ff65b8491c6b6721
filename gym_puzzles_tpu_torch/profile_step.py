"""Where the port's main path spends the card's time.

    python -m gym_puzzles_tpu_torch.profile_step [steps]

Runs ``make("MultiRobotPuzzle-v0", num_envs=4096)`` on the card (reset,
10 warm-up steps of random actions), then traces ``steps`` more steps with
``torch.profiler`` and prints: the wall time per step (the tracer slows the
host), the device's busy share of that time (the sum of device-kernel times
over the wall time), the device kernels launched per step, and the top
kernels by device time.  The last line is the same as one JSON object.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gym_puzzles_tpu_torch import make

ENV_ID = "MultiRobotPuzzle-v0"
NUM_ENVS = 4096


def main(steps: int = 20) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    env = make(ENV_ID, num_envs=NUM_ENVS)
    dev = env.device
    state, _obs = env.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(2)
    acts = torch.rand((steps + 10, NUM_ENVS, env.cfg.act_dim), generator=gen, device=dev) * 2 - 1
    for k in range(10):
        state, *_ = env.step(state, acts[steps + k])
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(steps):
            state, *_ = env.step(state, acts[k])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    # device-side events only: the CPU ops that launched them carry the same
    # time as their own "self device" time and would count it twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [dict(name=e.key[:60], count=e.count, device_ms=e.self_device_time_total / 1e3)
           for e in kernels[:8]]
    out = dict(
        device=torch.cuda.get_device_name(0),
        steps=steps,
        wall_ms_per_step=1e3 * wall_s / steps,
        device_ms_per_step=device_us / 1e3 / steps,
        device_busy_share=(device_us / 1e6) / wall_s,
        kernels_per_step=launches / steps,
        top=top,
    )
    print(f"{steps} traced steps x {NUM_ENVS} envs on {out['device']}: "
          f"{out['wall_ms_per_step']:.3f} ms/step wall, {out['device_ms_per_step']:.3f} ms/step "
          f"on the device (busy share {out['device_busy_share']:.3f}), "
          f"{out['kernels_per_step']:.1f} kernels/step")
    for t in top:
        print(f"  {t['device_ms']:10.3f} ms  x{t['count']:<6d} {t['name']}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
