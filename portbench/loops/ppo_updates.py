"""PPO updates: ``PPO.train_step`` from the benchmark's own weights, the
first ``warmup_updates`` in set-up (their inputs and outputs kept for the
check), then updates until the window has passed, each ended by a device
synchronize, as a training loop that logs its metrics every update is.

The check follows the program step by step from its own state.  On each
set-up update's rollout, from the program's weights of that update: the
policy forward on the stored observations (values, log-probs), the sampled
actions from the same noise, the first ``ROLLOUT_STEPS`` env steps from the
state the update began in (normalized reward, done, normalized
observations or frames), and the observation of the state the rollout ended
in.  Then the learner on each stored rollout from the benchmark's weights,
with the minibatch orders drawn again from the learner generator's start
state: each update's loss, Adam's first moment after the first, the
parameters' change after the last.  The rollout's other env steps run inside its CUDA
graph, whose states are not kept.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import program, yardstick
from portbench.check import (RefEnv, cat_states, leaf_gaps, max_of, ref_state, rel_gap,
                             slice_state)
from portbench.loops import profiled, sub_seeds, sync
from portbench.reference import learner as rl

TIMED_UPDATES = 3  # updates under PhaseTimer in a traced run
TRACE_UPDATES = 2  # updates under the profiler in a traced run
ROLLOUT_STEPS = 2  # env steps of each checked rollout that the reference takes
READINGS = ("program", "control", "half_batch", "altered", "twin")


def _normalizer(n) -> dict:
    rms = lambda r: {"mean": r.mean, "var": r.var, "count": r.count}  # noqa: E731
    return {"obs_rms": rms(n.obs_rms), "ret_rms": rms(n.ret_rms), "returns": n.returns}


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        setup_t0: float) -> dict:
    from gym_puzzles_tpu_torch.train.ppo import AdamState, PhaseTimer

    algo = program.make_ppo(config, device)
    s_net, s_env, s_run = sub_seeds(seed, 3)
    ts = algo.init_state(seed=s_env)
    params = program.make_weights(ts.params, s_net, device)
    ts = ts.replace(params=params, opt_state=AdamState.zeros_like(params))
    ts.generator.manual_seed(s_run)
    start = {"params": {k: v.clone() for k, v in params.items()},
             "gen_state": ts.generator.get_state().clone()}
    # the rollout buffer the program writes (on the card, its graph's own)
    buffers = []
    made = algo.new_transition
    algo.new_transition = lambda: buffers.append(made()) or buffers[-1]
    samples = []
    for _u in range(int(traffic["warmup_updates"])):
        pre = ts
        ts, metrics = algo.train_step(ts)
        traj = {k: getattr(buffers[-1], k).clone() for k in
                ("obs", "action", "log_prob", "value", "reward", "done")}
        samples.append(dict(
            pre={"vstate": pre.vstate, "normalizer": _normalizer(pre.normalizer),
                 "last_obs": pre.last_obs, "params": pre.params, "count": pre.opt_state.count},
            post={"params": ts.params, "mu": ts.opt_state.mu, "count": ts.opt_state.count, "normalizer": _normalizer(ts.normalizer),
                  "last_obs": ts.last_obs, "vstate": ts.vstate},
            traj=traj, metrics={"loss": metrics["loss"]}))
    cfg = algo.cfg
    per_update = cfg.n_steps * cfg.n_envs
    ctx = {"traffic": traffic, "config": config, "num_envs": cfg.n_envs,
           "frameskip": algo.env.cfg.frameskip, "table": algo.env.logic.layout.table,
           "iters": (algo.env.cfg.velocity_iters, algo.env.cfg.position_iters),
           "flops": yardstick.update_flops(ts.params, algo.obs_shape, cfg.n_steps, cfg.n_envs,
                                           cfg.n_epochs, cfg.batch_size)}
    sync(device)
    setup_s = time.perf_counter() - setup_t0
    if trace:
        # PhaseTimer's updates first: the profiler runs after them
        timer = PhaseTimer(device)
        for _u in range(TIMED_UPDATES):
            ts, _m = algo.train_step(ts, timer=timer)
        ctx["phase_s"] = dict(timer.seconds)
        ctx["timed_updates"] = TIMED_UPDATES
        states = [ts.vstate]
        with profiled(ctx, device):
            for _u in range(TRACE_UPDATES):
                ts, _m = algo.train_step(ts)
                states.append(ts.vstate)
        ctx["updates"] = TRACE_UPDATES
        ctx["steps"] = TRACE_UPDATES * cfg.n_steps
        # the state at each rollout's end stands for its ticks
        ctx["tick_states"] = [(getattr(b, "vec", b),) * 2 for b in states[1:]]
        ctx["tick_weight"] = cfg.n_steps
    t0 = time.perf_counter()
    n_done = 0
    while True:
        ts, _m = algo.train_step(ts)
        sync(device)
        n_done += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    ctx.update(setup_seconds=setup_s, window_env_steps=n_done * per_update, window_seconds=elapsed,
               window_updates=n_done)
    return dict(attempted=len(samples), missing=[], samples=samples, start=start, ctx=ctx,
                release=algo)


# -- the check ---------------------------------------------------------------------


def check(out: dict, config: dict, device, kinds=("program",)) -> dict:
    """{kind: numbers}, ``kinds`` among :data:`READINGS`: the program's
    against the reference; the reference one precision lower in the
    program's place (``control``); a reference with a planted learner fault
    (``half_batch``: each minibatch's loss over its first half; ``altered``:
    one value of the rollout changed by 1); and ``twin``, the reference with
    each minibatch's sums in another order, which shows each number's
    round-off floor."""
    samples, start = out["samples"], out["start"]
    ref = follow(samples, start, config, device)
    res = {}
    for kind in kinds:
        if kind == "program":
            prog = program_quantities(samples, start, device)
        elif kind == "control":
            prog = follow(samples, start, config, device, lower=True)
        else:  # the learner's: the env steps are the reference's own
            prog = dict(ref, **follow(samples, start, config, device, learner=kind,
                                      env_step=False))
        res[kind] = compare(prog, ref)
    return res


def hparams(ppo: dict) -> dict:
    hp = {k: float(np.float32(ppo[k])) for k in
          ("learning_rate", "clip_range", "ent_coef", "vf_coef", "max_grad_norm", "gamma",
           "gae_lambda")}
    hp["target_kl"] = float(np.float32(ppo["target_kl"] or 0.0))
    return hp


def _rms(d: dict, device) -> dict:
    return {k: v.to(device) for k, v in d.items()}


def _vec(s):
    return getattr(s, "vec", s)


def program_quantities(samples: list, start: dict, device) -> dict:
    """What the program produced in the checked updates, as :func:`follow`
    gives the reference's."""
    params0 = start["params"]
    last = samples[-1]["post"]["params"]
    K = ROLLOUT_STEPS
    return {
        "value": [x["traj"]["value"].reshape(-1).to(device) for x in samples],
        "log_prob": [x["traj"]["log_prob"].reshape(-1).to(device) for x in samples],
        "action": [x["traj"]["action"].to(device) for x in samples],
        "loss": [float(x["metrics"]["loss"]) for x in samples],
        "mu": {k: v.to(device) for k, v in samples[0]["post"]["mu"].items()},
        "change": {k: (last[k] - params0[k]).to(device) for k in params0},
        "reward": [x["traj"]["reward"][:K].to(device) for x in samples],
        "done": [x["traj"]["done"][:K].to(device) for x in samples],
        "obs": [x["traj"]["obs"][:K + 1].to(device) for x in samples],
        "end_obs": [x["post"]["last_obs"].to(device) for x in samples],
    }


@torch.no_grad()
def _env_steps(samples, config, device, lower: bool) -> dict:
    """The first :data:`ROLLOUT_STEPS` env steps of each checked rollout
    through the reference, from the state the update began in with the
    stored (clipped) actions, the reference's own state carried from step to
    step: the normalized rewards, dones and the normalized observations
    (flat) or frame stacks' newest frames (image); and the observation of
    the program's state at the rollout's end.  All rollouts in one batch."""
    ref = RefEnv(config)
    image = config.get("image") is not None
    dtype = torch.bfloat16 if lower else None
    low = (lambda x: x.to(torch.bfloat16).float()) if lower else (lambda x: x)
    E, K = config["env"]["num_envs"], ROLLOUT_STEPS
    gamma = float(np.float32(config["ppo"]["gamma"]))
    state = cat_states([ref_state(_vec(x["pre"]["vstate"]), device, dtype)
                              for x in samples])
    chains = []
    for x in samples:
        norm = x["pre"]["normalizer"]
        last = x["pre"]["last_obs"].to(device)
        c = {"ret_rms": _rms(norm["ret_rms"], device), "returns": norm["returns"].to(device),
             "reward": [], "done": [], "obs": [last]}
        if not image:
            c["obs_rms"] = rl.rms_update(_rms(norm["obs_rms"], device), last)
            c["obs"] = [low(rl.normalize_obs(c["obs_rms"], last))]
        chains.append(c)
    for t in range(K):
        action = torch.cat([torch.clamp(x["traj"]["action"][t].to(device), -1.0, 1.0)
                            for x in samples])
        state, robs, rrew, rdone = ref.step(state, action, dtype)
        for i, c in enumerate(chains):
            sl = slice(i * E, (i + 1) * E)
            c["ret_rms"], c["returns"], n_rew = rl.normalize_reward(
                c["ret_rms"], c["returns"], gamma, rrew[sl], rdone[sl])
            c["reward"].append(low(n_rew))
            c["done"].append(rdone[sl])
            if image:
                c["obs"].append(ref.render(slice_state(state, sl)))
            else:
                c["obs_rms"] = rl.rms_update(c["obs_rms"], robs[sl])
                c["obs"].append(low(rl.normalize_obs(c["obs_rms"], robs[sl])))
    end = cat_states([ref_state(_vec(x["post"]["vstate"]), device, dtype)
                            for x in samples])
    seen = ref.render(end) if image else low(ref.logic.observe(end, ref.params).T)
    return {"reward": [torch.stack(c["reward"]) for c in chains],
            "done": [torch.stack(c["done"]) for c in chains],
            "obs": [c["obs"] for c in chains],
            "end_obs": [seen[i * E:(i + 1) * E] for i in range(len(samples))]}


def follow(samples: list, start: dict, config: dict, device, lower: bool = False,
           learner: str | None = None, env_step: bool = True) -> dict:
    """The reference's quantities for the checked updates (see the module's
    docstring).  ``lower``: the next precision below the configuration's
    (dense operands in TF32, convolution operands in fp8, physics state in
    bfloat16).  ``learner``: ``half_batch``, ``altered`` or ``twin`` (see
    :func:`check`).  ``env_step=False`` leaves the env steps out."""
    ppo = config["ppo"]
    hp = hparams(ppo)
    image = config.get("image") is not None
    fw = {"lower": lower}
    params = {k: v.to(device) for k, v in start["params"].items()}
    params0 = dict(params)
    opt = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
           "nu": {k: torch.zeros_like(v) for k, v in params.items()},
           "count": torch.zeros((), dtype=torch.int32, device=device)}
    gen = torch.Generator(device=device)
    gen.set_state(start["gen_state"])
    n_epochs, E, T = ppo["n_epochs"], config["env"]["num_envs"], ppo["n_steps"]
    q = {"value": [], "log_prob": [], "action": [], "loss": [], "mu": None, "_applied": []}
    with rl.precision():
        for x in samples:
            traj = {k: v.to(device) for k, v in x["traj"].items()}
            act_dim = traj["action"].shape[-1]
            noise = torch.randn((T, E, act_dim), generator=gen, device=device)
            perms = torch.stack([torch.randperm(T * E, generator=gen, device=device)
                                 for _ in range(n_epochs)])
            with torch.no_grad():
                flat = traj["obs"].reshape((T * E,) + traj["obs"].shape[2:])
                acts = traj["action"].reshape(T * E, -1)
                chunk = 2048 if image else T * E
                vals, lps, means = [], [], []
                # the rollout's forward, from the program's weights of that update
                prog_params = {k: v.to(device) for k, v in x["pre"]["params"].items()}
                for i in range(0, T * E, chunk):
                    mean, log_std, value = rl.forward(prog_params, flat[i:i + chunk], **fw)
                    vals.append(value)
                    means.append(mean)
                    lps.append(rl.log_prob(mean, log_std, acts[i:i + chunk]))
                value = torch.cat(vals)
                if learner == "altered":
                    value[0] += 1.0
                q["value"].append(value)
                q["log_prob"].append(torch.cat(lps))
                sampled = torch.cat(means).reshape(T, E, act_dim) + torch.exp(log_std) * noise
                q["action"].append(sampled)
                norm = x["post"]["normalizer"]
                last = x["post"]["last_obs"].to(device)
                if ppo["normalize"] and not image:
                    last = rl.normalize_obs(_rms(norm["obs_rms"], device), last)
                last_value = rl.forward(params, last, **fw)[2]
            params, opt, loss, n_applied = rl.update(
                params, opt, traj, last_value, perms, hp, ppo["batch_size"],
                half=learner == "half_batch", reverse=learner == "twin", **fw)
            q["loss"].append(float(loss))
            q["_applied"].append([int(x["post"]["count"]) - int(x["pre"]["count"]), n_applied])
            if q["mu"] is None:
                q["mu"] = opt["mu"]
    q["change"] = {k: params[k] - params0[k] for k in params}
    if env_step:
        q.update(_env_steps(samples, config, device, lower))
    return q


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of the PPO cells, ``prog`` held against ``ref``.

    ``value_gap``, ``logp_gap``, ``action_gap``: the rollout's values,
    log-probs and sampled actions, the largest gap over the largest
    reference value.  ``loss_gap``: each update's mean loss, absolute.
    ``grad_gap``: Adam's first moment after the first update, the worst
    leaf's gap of norms.  ``change_gap``: the parameters' change after the
    last update, the median leaf's gap of norms.
    ``reward_gap``, ``done_diff``: the env steps' normalized rewards and
    dones; ``obs_gap``: their normalized observations, or the share of
    differing bytes of the newest frame; ``end_obs_gap``: the same of the
    observation the rollout ended on.  A step after an env was done on
    either side is not judged (the program's next state is a spawn the
    reference does not have), nor is a flat observation after it (the batch
    statistics take the spawn in)."""
    mu_gaps = leaf_gaps(prog["mu"], ref["mu"], list(ref["mu"]))
    out = {"value_gap": max(rel_gap(a, b) for a, b in zip(prog["value"], ref["value"])),
           "logp_gap": max(rel_gap(a, b) for a, b in zip(prog["log_prob"], ref["log_prob"])),
           "action_gap": max(rel_gap(a, b) for a, b in zip(prog["action"], ref["action"])),
           "loss_gap": max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"])),
           "grad_gap": max(mu_gaps.values())}
    # leaves whose first gradient is nought to rounding in the reference move
    # under Adam by round-off alone: left out of the change by that rule
    gn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["mu"].items()}
    med = float(np.median(list(gn.values())))
    moved = [k for k in gn if gn[k] >= 1e-3 * med]
    # the median leaf's: the worst leaf's is the rounding noise of a small
    # leaf (a convolution's bias, log_std), kept for the record
    leaves = leaf_gaps(prog["change"], ref["change"], moved)
    out["change_gap"] = float(np.median(list(leaves.values())))
    out["_change_worst"] = max(leaves.values())
    out["_change_worst_leaf"] = max(leaves, key=leaves.get)
    out["_grad_leaves"] = mu_gaps
    out["_applied"] = ref["_applied"]  # minibatches applied: [program, reference]
    if "reward" not in ref:
        return out
    rewards, dones, obs = [0.0], [0], [0.0]
    for pr, rr, pd, rd, po, ro in zip(prog["reward"], ref["reward"], prog["done"], ref["done"],
                                      prog["obs"], ref["obs"]):
        image = po[0].dtype == torch.uint8
        if not image:
            obs.append(max_of((po[0] - ro[0]).abs()))
        for t in range(len(pr)):
            if bool(pd[:t].any() | rd[:t].any()):
                break  # an env was reset: the reference's state is not the program's
            rewards.append(max_of((pr[t] - rr[t]).abs()))
            dones.append(int((pd[t] != rd[t]).sum()))
            keep = ~pd[t] & ~rd[t]
            if image:  # the newest frame of the next stack, envs not reset
                h = ro[t + 1].shape[1]
                diff = (po[t + 1][:, -h:] != ro[t + 1]).flatten(1).float().mean(dim=1)[keep]
                obs.append(float(diff.mean()) if diff.numel() else 0.0)
            elif bool(keep.all()):
                obs.append(max_of((po[t + 1] - ro[t + 1]).abs()))
    out.update(reward_gap=max(rewards), done_diff=sum(dones), obs_gap=max(obs))
    ends = []
    for pe, re_ in zip(prog["end_obs"], ref["end_obs"]):
        if pe.dtype == torch.uint8:
            h = re_.shape[1]
            ends.append(float((pe[:, -h:] != re_).float().mean()))
        else:
            ends.append(max_of((pe - re_).abs()))
    out["end_obs_gap"] = max(ends)
    return out
