"""The benchmark's arithmetic: the card's published peaks, the tick kernel's
operation and byte counts, the policy's FLOPs per update, and the reading of
a ``torch.profiler`` trace (device kernels, the union of their intervals,
idle gaps).

Copied, so that a change to the program cannot move them:

* the peaks and the tick's counts from ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
  ``F32_OPS_PER_S``, ``OPS_*``, ``narrowphase_ops``, ``sweep_ops``,
  ``bound``, ``kernel_bound``), recounted here from the world's state (bodies
  awake, pairs touching) instead of the kernel's packed argument planes;
* the device-time arithmetic from ``gym_puzzles_tpu_torch/profile_step.py::
  trace`` (device kernels only, top kernels by time), with the busy share
  taken from the union of kernel intervals over the traced window instead of
  a sum of kernel times.
"""

from __future__ import annotations

import json

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # bfloat16 on the tensor cores
PEAKS = {"float32": F32_FLOPS_PER_S, "bfloat16": BF16_FLOPS_PER_S}

# Float32 operations per unit of work in the tick kernel, counted from the
# source (each multiply, add, compare, min/max, select or divide is one;
# cos/sin count as 20).  A pair of two dynamic bodies ("dd") updates both.
OPS_VEL_PAIR = {True: 209, False: 154}  # one velocity-sweep visit
OPS_POS_PAIR = {True: 229, False: 157}  # one position-sweep visit
OPS_POS_SWEEP_BODY = 40  # cos/sin of each dynamic body once per position sweep
OPS_SETUP_PAIR = 190  # constraint setup of a pair
OPS_BODY = 150  # transforms, integration, islands and sleep per body


# -- the tick ------------------------------------------------------------------

def narrowphase_ops(table) -> list[int]:
    """SAT + clip operations of one narrow-phase visit, per pair."""
    ops = []
    for p in range(table.num_pairs):
        ca = int(table.fix_count[table.pair_fix_a[p]])
        cb = int(table.fix_count[table.pair_fix_b[p]])
        ops.append(28 + ca * (20 + 4 * cb) + cb * (20 + 4 * ca) + 5 * max(ca, cb) + 120)
    return ops


def sweep_ops(table, rows, vel_iters, pos_iters) -> int:
    """Operations of the velocity and position sweeps: ``rows[p]`` envs visit
    pair ``p`` in each sweep."""
    dyn = ~np.asarray(table.is_static)
    ops = 0
    for p, n in enumerate(rows):
        dd = bool(dyn[table.pair_body_a[p]] and dyn[table.pair_body_b[p]])
        ops += n * (vel_iters * OPS_VEL_PAIR[dd] + pos_iters * OPS_POS_PAIR[dd])
    return ops


def least_time(nbytes: float, flops_by_precision: dict) -> tuple[float, str]:
    """(seconds, what bounds it): the larger of the bytes at the HBM rate and
    the operations at the peak of the precision each runs in."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAKS[p] for p, n in flops_by_precision.items())
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tick_work(table, awake, touching, vel_iters: int, pos_iters: int) -> tuple[int, int]:
    """(bytes, float32 operations) one tick needs for a world whose bodies
    ``awake`` [B, E] (bool; static bodies count as awake) and pairs
    ``touching`` [P, E] (bool) are as given.  Every body is read (12 words:
    state and this tick's force, torque and wake) and written (8); every pair
    reads its touch flag, 2 ids and 4 impulses and writes 17 manifold and
    impulse words and 2 events; a pair whose bodies all sleep keeps its
    stored manifold and reads its 10 words instead of the narrow phase.  The
    narrow phase runs for the other pairs, the constraint setup and both
    sweeps for the live pairs (touching, with an awake dynamic body), the
    position sweep's per-body cos/sin in the envs that have a live pair."""
    B, P = table.num_bodies, table.num_pairs
    E = awake.shape[-1]
    dev = awake.device
    static = torch.as_tensor(np.asarray(table.is_static), device=dev)[:, None]
    aw = awake | static
    ia = torch.as_tensor(np.asarray(table.pair_body_a), dtype=torch.long, device=dev)
    ib = torch.as_tensor(np.asarray(table.pair_body_b), dtype=torch.long, device=dev)
    upd = aw[ia] | aw[ib]
    dyn_awake = awake & ~static
    live = touching & (dyn_awake[ia] | dyn_awake[ib])
    words = E * ((12 + 8) * B + (7 + 19) * P) + 10 * int((~upd).sum())
    n_dyn = int((~np.asarray(table.is_static)).sum())
    rows = live.sum(dim=-1).tolist()
    ops = (E * OPS_BODY * B
           + sum(n * c for n, c in zip(narrowphase_ops(table), upd.sum(dim=-1).tolist()))
           + OPS_SETUP_PAIR * sum(rows)
           + pos_iters * OPS_POS_SWEEP_BODY * n_dyn * int(live.any(dim=0).sum()))
    ops += sweep_ops(table, rows, vel_iters, pos_iters)
    return 4 * words, ops


# -- the policy ------------------------------------------------------------------

def policy_flops(params: dict, obs_shape) -> tuple[dict, dict]:
    """(forward, forward + backward) FLOPs of one sample, by precision, from
    the parameter shapes (keys as the port's ``state_dict``).  Dense layers
    count 2 * in * out; a VALID convolution 2 * out_h * out_w * out_c * in_c *
    k * k, in bfloat16; elementwise ops are not counted.  The backward pass
    counts the weight gradients of every layer and the input gradients of
    every layer but the first (the observation needs none)."""
    fwd = {"float32": 0, "bfloat16": 0}
    first = {"float32": 0, "bfloat16": 0}
    if "convs.0.weight" in params:
        h, w = int(obs_shape[0]), int(obs_shape[1])
        i = 0
        while f"convs.{i}.weight" in params:
            c_out, c_in, k, _ = params[f"convs.{i}.weight"].shape
            stride = (4, 2, 1)[i]
            h, w = (h - k) // stride + 1, (w - k) // stride + 1
            n = 2 * h * w * c_out * c_in * k * k
            fwd["bfloat16"] += n
            if i == 0:
                first["bfloat16"] = n
            i += 1
        names = ["dense.weight", "mean.weight", "value.weight"]
    else:
        names = [k for k in params if k.startswith("trunk.") and k.endswith(".weight")]
        names += ["mean.weight", "value.weight"]
        first["float32"] = 2 * params[names[0]].numel()
    for k in names:
        fwd["float32"] += 2 * params[k].numel()
    train = {p: 3 * fwd[p] - first[p] for p in fwd}
    return fwd, train


def update_flops(params: dict, obs_shape, n_steps: int, n_envs: int, n_epochs: int,
                 batch_size: int) -> dict:
    """FLOPs of one PPO update by precision: the rollout's forward pass on
    every step, the learner's bootstrap forward, and forward + backward on
    every minibatch of every epoch (the KL stop masks, it does not skip)."""
    fwd, train = policy_flops(params, obs_shape)
    total = n_steps * n_envs
    mb = max(1, min(batch_size, total))
    trained = n_epochs * (total // mb) * mb
    return {p: fwd[p] * (total + n_envs) + train[p] * trained for p in fwd}


# -- the trace -------------------------------------------------------------------

def read_trace(path) -> tuple[list, list]:
    """(device kernels, host ops) of a chrome trace that ``torch.profiler``
    exported: [(name, start_us, dur_us)], device ops being the events of
    category ``kernel``, ``gpu_memcpy`` or ``gpu_memset``, host ops those of
    ``cpu_op``, ``cuda_runtime``, ``cuda_driver`` and ``user_annotation``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        row = (e.get("name", "?"), float(e["ts"]), float(e["dur"]))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append(row)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"):
            host.append(row)
    return dev, host


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, dur) intervals, clipped to [lo, hi]."""
    spans = sorted((max(lo, s), min(hi, s + d)) for _n, s, d in intervals)
    total, end = 0.0, lo
    for s, e in spans:
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals, host, lo: float, hi: float, top: int = 10) -> list:
    """The idle gaps of the device between ``lo`` and ``hi``, summed by what
    the host was doing at each gap's middle (the shortest host op that spans
    it, ``host`` when none does): [[name, seconds]], longest first."""
    spans = sorted((s, s + d) for _n, s, d in intervals)
    gaps, end = [], lo
    for s, e in spans:
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    host = sorted(host, key=lambda r: r[1])
    starts = [r[1] for r in host]
    by = {}
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        k = int(np.searchsorted(starts, mid))
        name, best = "host", None
        for n, s, d in host[max(0, k - 400):k]:
            if s <= mid <= s + d and (best is None or d < best):
                name, best = n, d
        by[name] = by.get(name, 0.0) + (b - a) * 1e-6
    return sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])[:top]


def top_ops(intervals, top: int = 10) -> list:
    """Device ops by total time: [[name, seconds]], longest first."""
    by = {}
    for n, _s, d in intervals:
        by[n] = by.get(n, 0.0) + d * 1e-6
    return sorted(([k[:200], v] for k, v in by.items()), key=lambda r: -r[1])[:top]


def device_ms_per_step(ctx) -> float | None:
    """The device ops' summed time per traced step, in ms; None without a
    trace or with no device op in it."""
    ops = ctx.get("device_ops")
    if not ops or not ctx.get("steps"):
        return None
    return sum(d for _n, _s, d in ops) * 1e-3 / ctx["steps"]


def idle_share(ctx) -> float | None:
    """1 - the union of the device ops' intervals over the traced window, in
    %; None without a trace or with no device op in it."""
    ops = ctx.get("device_ops")
    if not ops:
        return None
    lo, hi = ctx["trace_lo"], ctx["trace_hi"]
    return 100.0 * (1.0 - union_us(ops, lo, hi) / (hi - lo))


def tick_least_time(ctx) -> float | None:
    """The least time of the traced ticks, in s: each pair (before, after)
    of ``tick_states`` stands for ``tick_weight`` env steps of ``frameskip``
    ticks, counted from the bodies awake at either end and the pairs
    touching after; None without traced states."""
    if not ctx.get("tick_states"):
        return None
    vi, pi = ctx["iters"]
    ticks = ctx.get("tick_weight", 1) * ctx["frameskip"]
    least = 0.0
    for a, b in ctx["tick_states"]:
        awake = a.bodies.awake | b.bodies.awake
        nbytes, ops_n = tick_work(ctx["table"], awake, b.contacts.touching, vi, pi)
        least += ticks * least_time(nbytes, {"float32": ops_n})[0]
    return least


def tick_roofline(ctx, kernels) -> float | None:
    """The tick kernel's least time (:func:`tick_least_time`) over its traced
    device time, in %; None where no kernel of those names ran."""
    ops = [d for n, _s, d in ctx.get("device_ops", ()) if any(k in n for k in kernels)]
    least = tick_least_time(ctx)
    if not ops or least is None:
        return None
    return 100.0 * least / (sum(ops) * 1e-6)


# -- the readers' shared arithmetic ------------------------------------------------

def window_rate(ctx) -> float:
    """Env steps x envs completed in the window over its wall time."""
    return ctx["window_env_steps"] / ctx["window_seconds"]


def phase_ms(ctx, phase: str) -> float | None:
    """Wall ms per update that ``PhaseTimer`` put on ``phase`` (``rollout``
    or ``update``) over the traced run's timed updates."""
    s = ctx.get("phase_s", {}).get(phase)
    return None if s is None else 1e3 * s / ctx["timed_updates"]


def update_mfu(ctx) -> float | None:
    """The whole update's share of the card's peak, in %: the policy's FLOPs
    per update (:func:`update_flops`), each at the peak of the precision it
    runs in, over the wall time per update that ``PhaseTimer`` measured
    (rollout + learner)."""
    ph = ctx.get("phase_s")
    if not ph or "flops" not in ctx:
        return None
    wall = (ph.get("rollout", 0.0) + ph.get("update", 0.0)) / ctx["timed_updates"]
    t, _by = least_time(0.0, ctx["flops"])
    return 100.0 * t / wall
