"""Env steps: uniform random actions, drawn from the seed into a pool on the
device during set-up, through ``env.step`` (CUDA graph replays), one step
after another.  The window counts env steps x envs over its wall time, from
one device synchronize to the next.

The check keeps the inputs and outputs of one step drawn from the seed in
the first half of the first episode, and of the first step at which every
env reaches the episode limit (fast autoreset spawns all envs at once); a
checked step the window did not reach is stepped to after it, untimed.  The
reference steps the program's pre-states with the same actions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import program
from portbench.check import RefEnv, cat_states, max_of, ref_state
from portbench.loops import profiled, sub_seeds, sync
from portbench.reference import common as rcm

ACTION_POOL_STEPS = 512  # actions drawn in set-up, replayed in turn
TRACE_STEPS = 100  # env steps under the profiler in a traced run
READINGS = ("program", "control")


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        setup_t0: float) -> dict:
    env = program.make_env(config, device)
    s_env, s_act, s_pick = sub_seeds(seed, 3)
    E, A = env.num_envs, env.cfg.act_dim
    pool_n = ACTION_POOL_STEPS
    gen = torch.Generator(device=device).manual_seed(s_act)
    pool = torch.rand((pool_n, E, A), generator=gen, device=device) * 2.0 - 1.0
    state, _obs = env.reset(seed=s_env)
    warm = int(traffic["warmup_steps"])
    for k in range(warm):
        state, *_ = env.step(state, pool[k % pool_n])
    samples = {}
    ctx = {"traffic": traffic, "config": config, "num_envs": E,
           "frameskip": env.cfg.frameskip, "table": env.logic.layout.table,
           "iters": (env.cfg.velocity_iters, env.cfg.position_iters)}
    sync(device)
    setup_s = time.perf_counter() - setup_t0
    if trace:
        n = TRACE_STEPS
        # the traced steps keep their states: grow the allocator's pool to
        # hold them first, so that no cudaMalloc falls inside the trace
        states = [state]
        for k in range(n):
            state, *_ = env.step(state, pool[(warm + k) % pool_n])
            states.append(state)
        warm += n
        states = [state]
        sync(device)
        with profiled(ctx, device):
            for k in range(n):
                state, *_ = env.step(state, pool[(warm + k) % pool_n])
                states.append(state)
        vec = (lambda s: s.vec) if config.get("image") else (lambda s: s)
        ctx["steps"] = n
        ctx["tick_states"] = [(vec(a), vec(b)) for a, b in zip(states[:-1], states[1:])]
        warm += n
    # every env reaches the episode limit together (fast autoreset, all
    # spawned at once): the window's first such step is checked too
    limit = env.cfg.max_episode_steps
    pick = int(np.random.default_rng(s_pick).integers(1, max(2, limit // 2)))
    checked = {pick, (limit - 1 - warm) % limit}

    def step(k):
        nonlocal state
        act = pool[(warm + k) % pool_n]
        pre = state
        state, obs, reward, done, _info = env.step(state, act)
        if k in checked:
            samples[k] = dict(pre=pre, action=act, post=state, obs=obs, reward=reward, done=done)

    t0 = time.perf_counter()
    k = 0
    while True:
        step(k)
        k += 1
        if k % 16 == 0 and time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    ctx.update(setup_seconds=setup_s, window_env_steps=k * E, window_seconds=elapsed)
    # a checked step the window did not reach comes after it, untimed, within
    # a minute
    late = time.perf_counter()
    while set(samples) != checked and time.perf_counter() - late < 60.0:
        step(k)
        k += 1
    missing = sorted(checked - set(samples))
    return dict(attempted=len(checked), missing=missing,
                samples=[samples[k] for k in sorted(samples)], ctx=ctx, release=env)


def check(out: dict, config: dict, device, kinds=("program",)) -> dict:
    """{kind: numbers} of the checked steps (``out["samples"]``), ``kinds``
    among :data:`READINGS`."""
    if not out["samples"]:
        return {kind: {} for kind in kinds}
    return {kind: compare(out["samples"], config, device, control=kind == "control")
            for kind in kinds}


def compare(samples: list, config: dict, device, control: bool = False) -> dict:
    """Numbers of the env cells.  ``samples``: dicts with the program's
    ``pre`` state, ``action`` [E, act_dim] and its outputs ``post``, ``obs``,
    ``reward``, ``done`` of one ``env.step`` each; the image env's states
    carry ``vec`` and ``frames``.  All samples go through the reference as
    one batch: ``tick_gap`` (positions, m, and angles, rad, of envs no side
    reset), ``reward_gap``, ``done_diff``, ``obs_gap`` (flat) or
    ``frame_diff`` (share of differing frame bytes), and for reset envs
    ``reset_bad`` (no fresh spawn), ``reset_gap`` (obs against the
    reference's observation of that spawn) or ``stack_bad`` (the frame
    stack).  ``control``: the reference with its physics state in bfloat16
    takes the program's place wherever the program did not reset."""
    ref = RefEnv(config)
    image = config.get("image") is not None
    vec = (lambda s: s.vec) if image else (lambda s: s)
    pre = cat_states([ref_state(vec(x["pre"]), device) for x in samples])
    post = cat_states([ref_state(vec(x["post"]), device) for x in samples])
    action = torch.cat([x["action"].to(device) for x in samples])
    reward = torch.cat([x["reward"].to(device) for x in samples])
    done = torch.cat([x["done"].to(device) for x in samples])
    reset = done.clone()  # the envs the program spawned anew
    if image:
        frames = torch.cat([x["post"].frames.to(device) for x in samples])
        newest = frames[:, -1]
    else:
        obs = torch.cat([x["obs"].to(device) for x in samples])
    rs, robs, rrew, rdone = ref.step(pre, action)
    if control:
        low = torch.bfloat16
        pre_l = cat_states([ref_state(vec(x["pre"]), device, low) for x in samples])
        cs, cobs, reward, done = ref.step(pre_l, action, low)
        post = rcm.select(reset, post, cs)
        if image:
            newest = torch.where(reset[:, None, None, None], newest, ref.render(cs))
        else:
            obs = torch.where(reset[:, None], obs, cobs)
    keep = ~done & ~rdone
    out = {
        "tick_gap": max(max_of((post.bodies.pos - rs.bodies.pos).abs().amax(dim=(0, 1))[keep]),
                        max_of((post.bodies.angle - rs.bodies.angle).abs().amax(dim=0)[keep])),
        "reward_gap": max_of((reward - rrew).abs()),
        "done_diff": int((done != rdone).sum()),
        "reset_bad": int((ref.logic.spawn_bad(post) & reset).sum()),
    }
    if not image:
        out["obs_gap"] = max_of((obs - robs).abs().amax(dim=1)[keep])
        # a reset env's obs is its spawn's, as the reference observes it
        spawn_obs = ref.logic.observe(post, ref.params).T
        out["reset_gap"] = max_of((obs - spawn_obs).abs().amax(dim=1)[reset])
    else:
        # the frame is drawn from the state after autoreset: the reference
        # draws the program's state where the program reset, its own elsewhere
        drawn = torch.where(reset[:, None, None, None], ref.render(post), ref.render(rs))
        out["frame_diff"] = float((newest != drawn).float().mean())
        older = torch.cat([x["pre"].frames.to(device)[:, 1:] for x in samples])
        want = torch.where(reset[:, None, None, None, None], 0, older)
        out["stack_bad"] = int((frames[:, :-1] != want).flatten(1).any(dim=1).sum())
    return out
