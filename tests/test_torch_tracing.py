"""The port's spans and counters (``utils/profiling.py``) on the CPU, at 4/2
solver iterations.

* With tracing off a span is one shared no-op and nothing is recorded.
* Tracing on changes no output: a v0 ``step_eager``, an image
  ``step_eager`` and a tiny ``train_step_eager`` give the same outputs bit
  for bit as with it off.
* The spans nest as named: the env's device spans under ``env.step``, one
  ``learn.grad`` and one ``learn.adam`` per minibatch (``n_epochs x
  n_minibatch``) under ``ppo.learner``, step ids from the step spans.
* Self time is a span's duration minus what its children on the same clock
  cover; ``PhaseTimer`` reads the ``ppo.rollout`` / ``ppo.learner`` blocks
  with tracing on or off.
* ``trace(dir)`` writes the program's spans as rows of the profiler's
  Chrome trace, puts the idle time down to the innermost host span and each
  host span's launches' device extent to that span; ``traced_calls`` times
  calls with tracing on, then profiles more.
* ``cuda``-marked (skipped without a card): a graph captured with tracing on
  holds its stamps and replays as the eager body does; one captured with it
  off holds none; the kernel-node counter.
"""

import contextlib
import json

import pytest
import torch

import gym_puzzles_tpu_torch as gpt
from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
from gym_puzzles_tpu_torch.train.ppo import PPO, PhaseTimer, PPOConfig
from gym_puzzles_tpu_torch.utils import profiling
from gym_puzzles_tpu_torch.utils.profiling import Span, Trace

torch.set_num_threads(1)

ITERS = dict(velocity_iters=4, position_iters=2)
ENV_SPANS = ("env.control", "env.tick", "env.score", "env.autoreset")
# v0 on the card: the spawn's draws, then the score that respawns the envs that end
CARD_ENV_SPANS = ("env.control", "env.tick", "env.autoreset", "env.score")


def leaves(x):
    return profiling._leaves(x)


def assert_bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def small_ppo(policy="mlp"):
    cfg = dict(n_envs=2, n_steps=3, batch_size=2, n_epochs=2, seed=5, **ITERS)
    if policy == "cnn":
        env = DeviceImageVectorEnv(num_envs=2, downsample=16, device="cpu", **ITERS)
        return PPO(PPOConfig(policy="cnn", **cfg), device="cpu", env=env)
    return PPO(PPOConfig(**cfg), device="cpu")


def test_tracing_off_records_nothing():
    assert not profiling.is_tracing()
    assert profiling.span("a") is profiling.span("b") is profiling.device_span("c", "cpu")
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=2, device="cpu", **ITERS)
    state, _ = env.reset(seed=0)
    state, *_ = env.step(state, torch.zeros(2, 6))
    with profiling.tracing() as tr:
        assert profiling.is_tracing()
    assert not profiling.is_tracing()
    assert tr.spans == [] and tr.steps == 0 and tr.stamps == 0


def _env_step_outputs(env, trace_on: bool, image: bool):
    gen = torch.Generator().manual_seed(3)
    state, _ = env.reset(seed=1)
    outs = []
    with profiling.tracing() if trace_on else contextlib.nullcontext() as tr:
        for _ in range(3):
            a = torch.rand((2, 6), generator=gen) * 2 - 1
            out = env.step_eager(state, a)
            outs.append(out)
            state = out[0]
    return outs, tr


@pytest.mark.parametrize("image", [False, True], ids=["v0", "image"])
def test_tracing_on_changes_no_env_output(image):
    def make():
        if image:
            return DeviceImageVectorEnv(num_envs=2, downsample=16, device="cpu", **ITERS)
        return gpt.make("MultiRobotPuzzle-v0", num_envs=2, device="cpu", **ITERS)

    off, _ = _env_step_outputs(make(), False, image)
    on, tr = _env_step_outputs(make(), True, image)
    assert_bitwise(on, off)
    names = [s.name for s in tr.spans]
    want = ENV_SPANS + (("env.render",) if image else ())
    if image:  # frameskip 4: four ticks, each a launch (here the plain tick)
        want = ("env.control",) + ("env.tick",) * 4 + want[2:]
    assert names == list(want) * 3  # step_eager alone: device spans, no host span
    assert all(s.clock == "device" and s.parent is None and s.step == 0 for s in tr.spans)


def test_tracing_on_changes_no_learner_output():
    def run(trace_on):
        algo = small_ppo()
        ts = algo.init_state()
        with profiling.tracing() if trace_on else contextlib.nullcontext():
            ts, metrics = algo.train_step_eager(ts)
        return ts.params, ts.opt_state, ts.normalizer, ts.vstate, metrics

    assert_bitwise(run(True), run(False))


def test_env_spans_nest_under_the_step():
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=2, device="cpu", **ITERS)
    state, _ = env.reset(seed=0)
    with profiling.tracing() as tr:
        for _ in range(2):
            state, *_ = env.step(state, torch.zeros(2, 6))
    assert tr.steps == 2 and tr.stamps == 2 * 2 * len(ENV_SPANS)
    steps = [i for i, s in enumerate(tr.spans) if s.name == "env.step"]
    assert [tr.spans[i].step for i in steps] == [1, 2]
    for i in steps:
        kids = [tr.spans[k] for k in tr.children(i)]
        assert [k.name for k in kids] == list(ENV_SPANS)
        assert all(k.clock == "device" and k.step == tr.spans[i].step for k in kids)
        assert all(tr.spans[i].start <= k.start <= k.end <= tr.spans[i].end for k in kids)


@pytest.mark.parametrize("policy", ["mlp", "cnn"])
def test_learner_spans_nest_as_named(policy):
    algo = small_ppo(policy)
    ts = algo.init_state()
    cfg = algo.cfg
    n_minibatch = cfg.n_steps * cfg.n_envs // cfg.batch_size
    with profiling.tracing() as tr:
        ts, _m = algo.train_step(ts)
        ts, _m = algo.train_step(ts)
    by = {}
    for s in tr.spans:
        by.setdefault(s.name, []).append(s)
    parent = lambda s: tr.spans[s.parent].name  # noqa: E731
    assert tr.steps == 2 and [s.step for s in by["ppo.update"]] == [1, 2]
    for name in ("ppo.noise", "ppo.rollout", "ppo.learner"):
        assert len(by[name]) == 2 and all(parent(s) == "ppo.update" for s in by[name])
    for name in ("learn.grad", "learn.adam"):
        assert len(by[name]) == 2 * cfg.n_epochs * n_minibatch
        assert all(parent(s) == "ppo.learner" and s.clock == "device" for s in by[name])
    for name in ("learn.gae", "learn.metrics"):
        assert len(by[name]) == 2 and all(parent(s) == "ppo.learner" for s in by[name])
    assert len(by["rollout.policy"]) == 2 * cfg.n_steps
    for name in ("rollout.policy",) + ENV_SPANS + (("env.render",) if policy == "cnn" else ()):
        assert all(parent(s) == "ppo.rollout" for s in by[name]), name
    # a minibatch's gradient, then its optimizer step, in order
    learn = [s.name for s in tr.spans if s.name.startswith("learn.")]
    first = ["learn.gae"] + ["learn.grad", "learn.adam"] * n_minibatch
    assert learn[:len(first)] == first
    # the second update's spans carry its step
    assert {s.step for s in by["learn.adam"]} == {1, 2}


def test_phase_timer_reads_the_span_blocks():
    algo = small_ppo()
    ts = algo.init_state()
    for trace_on in (False, True):
        timer = PhaseTimer("cpu")
        with profiling.tracing() if trace_on else contextlib.nullcontext() as tr:
            ts, _m = algo.train_step(ts, timer=timer)
        assert set(timer.seconds) == {"rollout", "update"}
        assert all(v > 0 for v in timer.seconds.values())
        if trace_on:
            (learner,) = tr.named("ppo.learner")
            assert learner.duration * 1e-9 <= timer.seconds["update"]


def test_self_time_is_duration_minus_children():
    tr = Trace()
    tr.spans = [Span("outer", "host", 0, 100, None, 1),
                Span("a", "host", 10, 30, 0, 1), Span("b", "host", 20, 50, 0, 1),
                Span("c", "host", 60, 70, 0, 1), Span("d", "device", 0, 90, 0, 1),
                Span("e", "host", 22, 25, 2, 1)]
    assert tr.self_ns(0) == 100 - (40 + 10)
    assert tr.self_ns(2) == 30 - 3 and tr.self_ns(3) == 10 and tr.self_ns(4) == 90
    summary = tr.by_name()
    assert summary["outer"] == {"clock": "host", "count": 1, "total_ns": 100, "self_ns": 50}
    assert summary["b"]["self_ns"] == 27 and summary["d"]["clock"] == "device"


def test_trace_writes_the_spans_and_names_the_idle_time(tmp_path):
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=2, device="cpu", **ITERS)
    state, _ = env.reset(seed=0)
    with profiling.trace(str(tmp_path)) as tr:
        state, *_ = env.step(state, torch.zeros(2, 6))
    assert tr.fit["host_spans"] == 1 and tr.fit["device_stamps"] == 2 * len(ENV_SPANS)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    rows = [e for e in events if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in rows) == sorted(("env.step",) + ENV_SPANS)
    assert {e["tid"] for e in rows} == {"host", "device"}
    # no device op on the CPU: the whole step is idle, put down to env.step
    assert tr.idle[0][0] == "env.step" and tr.device_us == 0.0
    with profiling.trace(None) as none:
        assert none is None


def test_idle_gaps_go_to_the_innermost_host_span():
    tr = Trace()
    tr.spans = [Span("env.step", "host", 0, 100_000, None, 1),
                Span("graph.inputs", "host", 0, 20_000, 0, 1),
                Span("graph.launch", "host", 20_000, 90_000, 0, 1)]
    # the spans as fit_clocks placed them on the trace's clock (us)
    tr._host_ts = {0: (1000.0, 100.0), 1: (1000.0, 20.0), 2: (1020.0, 70.0)}
    # device ops: busy 1010-1030 and 1040-1095
    events = [{"ph": "X", "cat": "kernel", "ts": 1010.0, "dur": 20.0},
              {"ph": "X", "cat": "kernel", "ts": 1040.0, "dur": 55.0}]
    idle = dict(profiling.idle_by_span(tr, events))
    assert idle.keys() == {"graph.inputs", "graph.launch", "env.step"}
    assert abs(idle["graph.inputs"] - 10e-6) < 1e-12  # 1000-1010
    assert abs(idle["graph.launch"] - 10e-6) < 1e-12  # 1030-1040
    assert abs(idle["env.step"] - 5e-6) < 1e-12  # 1095-1100


def test_launch_extents_follow_the_correlation_ids():
    tr = Trace()
    tr.spans = [Span("ppo.rollout", "host", 0, 50_000, None, 1),
                Span("ppo.learner", "host", 50_000, 100_000, None, 1)]
    tr._host_ts = {0: (1000.0, 50.0), 1: (1050.0, 50.0)}

    def op(cat, ts, dur, corr):
        return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "args": {"correlation": corr}}

    events = [op("cuda_runtime", 1010.0, 5.0, 1), op("cuda_runtime", 1060.0, 5.0, 2),
              op("kernel", 1020.0, 10.0, 1), op("kernel", 1040.0, 30.0, 1),  # ends past its span
              op("kernel", 1075.0, 5.0, 2), op("gpu_memcpy", 1090.0, 20.0, 2),
              op("kernel", 1000.0, 200.0, 9)]  # launched by nothing in the trace
    assert profiling.launch_extents(tr, events) == {"ppo.rollout": 50.0, "ppo.learner": 35.0}


def test_traced_calls_time_then_profile(tmp_path):
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=2, device="cpu", **ITERS)
    state = env.reset(seed=0)[0]
    ks = []

    def step(k):
        nonlocal state
        ks.append(k)
        state = env.step(state, torch.zeros(2, 6))[0]

    timed, wall_s, profiled = profiling.traced_calls(step, 2, 1, str(tmp_path))
    assert ks == [0, 1, 2, 3] and wall_s > 0
    assert len(timed.named("env.step")) == 2 and len(profiled.named("env.step")) == 1
    assert profiled.fit["host_spans"] == 1 and (tmp_path / "trace.json").exists()
    assert not profiling.is_tracing()


def test_device_span_on_two_devices_in_one_block_raises():
    with pytest.raises(ValueError, match="one device"):
        with profiling.tracing():
            with profiling.device_span("x", "cpu"):
                profiling._stamp(0, torch.device("meta"))
    assert not profiling.is_tracing()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: "
                    "python -m pytest --noconftest tests/test_torch_tracing.py")
    return torch.device("cuda")


@pytest.mark.cuda
def test_traced_replay_equals_eager_on_card(cuda_device):
    graphed = gpt.make("MultiRobotPuzzle-v0", num_envs=256, device=cuda_device)
    eager = gpt.make("MultiRobotPuzzle-v0", num_envs=256, device=cuda_device)
    gs, _ = graphed.reset(seed=0)
    es, _ = eager.reset(seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    acts = [torch.rand((256, 6), generator=gen, device=cuda_device) * 2 - 1 for _ in range(6)]
    for k, a in enumerate(acts):
        with profiling.tracing() if k >= 3 else contextlib.nullcontext() as tr:
            g = graphed.step(gs, a)
        e = eager.step_eager(es, a)
        assert_bitwise(g, e)
        gs, es = g[0], e[0]
        if k >= 4:  # the replay of the graph captured with tracing on
            assert [s.name for s in tr.spans if s.clock == "device"] == list(CARD_ENV_SPANS)
            launch = tr.named("graph.launch")[0]
            assert all(tr.spans[s.parent] is launch for s in tr.spans if s.clock == "device")
    off, on = [c for c in profiling.CAPTURES if c.name == "env.step"][-2:]
    assert not off.traced and on.traced
    assert on.kernel_nodes == off.kernel_nodes + 2 * len(ENV_SPANS)
