"""Tracing and profiling of the port (port of ``gym_puzzles_tpu/utils/profiling.py``).

The reference has no profiling beyond wandb's tensorboard relay
(train/train.py:53).  Here: spans and counters the program records where its
work happens, ``torch.profiler`` traces with those spans on the same clock,
and a determinism check.

**Spans.**  Each is named ``layer.part`` and opened as a context manager at
its call site.  With tracing off (the default) every span is one shared
no-op and nothing is recorded; :func:`tracing` turns it on for a block and
yields the :class:`Trace` that the block's spans fill in when it ends.

* :func:`span` -- a host span, on ``time.perf_counter_ns``.  While a
  ``torch.profiler`` is active it is also a ``record_function`` range, so it
  lands in the profiler's trace on the profiler's clock.  It can also time a
  phase for a ``timer`` (the learner's ``PhaseTimer``), tracing on or off.
* :func:`device_span` -- a span of the work a stream runs, marked by a stamp
  at each edge.  On a CUDA device a stamp is a one-thread kernel
  (``csrc/stamp.cu``, built through ``engine/_cuda_build.py``) that writes
  (site, ``%globaltimer``) into a ring in device memory, at a slot taken by
  an atomic: a stamp captured into a CUDA graph replays with it and keeps
  each replay's time, with no host read between replays.  The ring comes to
  the host once, when the block ends.  On the CPU, whose ops are
  synchronous, a stamp reads the host clock.

The host counts the stamps it launches, and a CUDA graph
(``utils/cuda_graph.py``) counts those it holds and adds them at each
replay, so each stamp's slot is known on the host: a device span's parent is
the device span around it, or else the innermost host span open when its
first stamp was launched (for a replay, ``graph.launch``); its step is its
parent's.  A host span opened with ``step=True`` (``env.step``,
``ppo.update``) starts the next step, unless it sits inside another.

**Counters**: :data:`CAPTURES`, kept with tracing on or off, one record per
CUDA graph capture -- its name, the seconds of its warm-up and capture, and
the kernel nodes (and all nodes) of the captured graph; :data:`LIVE_PAIRS`,
kept with tracing on only, one record of kernel A's load per world state
that :func:`count_live_pairs` is given, marked with the site that gave it
(``ppo.update``: the learner gives the state each rollout ends in, after its
update's spans have closed; ``env.step``: ``VectorEnv.step`` gives every
25th state it returns in a tracing block, outside its span); :data:`RESPAWNS`,
kept with tracing on only, one record per tracing block of what the v0
env's ``score_respawn`` kernel did there (envs respawned, env-steps scored),
which it adds up on the device through :func:`respawn_counts`.

:func:`trace` is the operator's exporter: the profiler and tracing together
over a block, written as one Chrome trace (``<dir>/trace.json``) whose rows
hold the profiler's events and the program's host and device spans, the
device spans put on the profiler's clock by a fit of the stamps' kernels.
:func:`traced_calls` runs a step function the way the benchmark reads the
spans: timed with tracing on, then under :func:`trace`.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

RING_CAPACITY = 1 << 20  # device stamps one tracing block keeps (16 MiB of ring)
STAMP_KERNEL = "gpt_stamp_kernel"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")  # device categories of a profiler trace
NO_SPAN = "(no span)"

_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    """One recorded span.  ``clock``: ``host`` (``time.perf_counter_ns``) or
    ``device`` (the card's ``%globaltimer``, ns; the host clock on the CPU).
    ``parent``: index of the enclosing span in :attr:`Trace.spans`, or None.
    ``step``: the step or update it belongs to (0: before the first)."""

    name: str
    clock: str
    start: int
    end: int
    parent: int | None
    step: int

    @property
    def duration(self) -> int:
        return self.end - self.start


@dataclasses.dataclass
class CaptureRecord:
    """One CUDA graph capture: ``seconds`` of its warm-up and capture,
    ``kernel_nodes`` and ``nodes`` of the captured graph, ``traced`` whether
    it holds the spans' stamps."""

    name: str
    seconds: float
    kernel_nodes: int
    nodes: int
    traced: bool


CAPTURES: list[CaptureRecord] = []  # every capture of this process, in order


@dataclasses.dataclass
class LivePairRecord:
    """Kernel A's load on one world state, as the sweeps of a tick from it
    find it: the live pairs per env (``_cuda_build.live_pairs``) -- ``mean``
    over the envs, ``warp_max`` the mean over warps of the most any env of
    the warp has (a warp runs as long as its most loaded env), ``max`` the
    most of any env -- at ``envs_per_warp`` (kernel A's build on a CUDA
    device; 1 on the CPU, which ticks with the plain version), the
    ``size_class`` of kernel A that the world's table takes, and the
    ``site`` that took the record (:func:`count_live_pairs`)."""

    num_envs: int
    mean: float
    warp_max: float
    max: float
    envs_per_warp: int
    size_class: int
    site: str


LIVE_PAIRS: list[LivePairRecord] = []  # every record of this process, in order


@dataclasses.dataclass
class RespawnRecord:
    """What the v0 env's ``score_respawn`` kernel (``envs/v0_cuda.py``) did
    over one tracing block on one device: the envs it ``respawned`` and the
    env-steps it ``scored``, each with its fast autoreset on."""

    device: str
    respawned: int
    scored: int


RESPAWNS: list[RespawnRecord] = []  # every record of this process, in order


class Trace:
    """What one :func:`tracing` block recorded, filled in when it ends:
    :attr:`spans` (host spans in the order they opened, then device spans in
    the order they ran), :attr:`steps` (step spans opened), :attr:`stamps`
    (device stamps run), :attr:`device`.  :func:`trace` adds :attr:`fit`
    (the clock fit), :attr:`idle` (the idle gaps by innermost span),
    :attr:`device_us` (the device ops' summed time in the profiler's trace)
    and :attr:`extents` (:func:`launch_extents`)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.steps = 0
        self.stamps = 0
        self.dropped = 0  # stamps past the ring's end, not kept
        self.device = None
        self.profiler = None
        self.fit: dict | None = None
        self.idle: list | None = None
        self.device_us: float | None = None
        self.extents: dict | None = None
        self._stamp_times = np.zeros((0,), np.int64)  # ns, ring order
        self._edges: dict = {}  # device span index -> ring positions of its stamps
        self._device_ts = None  # trace us of each stamp's kernel, ring order
        self._host_ts: dict | None = None  # host span index -> its range (ts, dur)

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, index: int) -> list[int]:
        return [i for i, s in enumerate(self.spans) if s.parent == index]

    def self_ns(self, index: int, children: list | None = None) -> int:
        """The span's duration minus the part of it that its children on the
        same clock cover (``children``: its children's indices, if known)."""
        s = self.spans[index]
        kids = sorted((max(c.start, s.start), min(c.end, s.end))
                      for c in (self.spans[i] for i in (
                          self.children(index) if children is None else children))
                      if c.clock == s.clock)
        covered, end = 0, s.start
        for a, b in kids:
            if b > end:
                covered += b - max(a, end)
                end = b
        return s.duration - covered

    def by_name(self) -> dict:
        """{name: {"clock", "count", "total_ns", "self_ns"}} over the spans."""
        kids: dict = {}
        for i, s in enumerate(self.spans):
            kids.setdefault(s.parent, []).append(i)
        out: dict = {}
        for i, s in enumerate(self.spans):
            row = out.setdefault(s.name, {"clock": s.clock, "count": 0, "total_ns": 0,
                                          "self_ns": 0})
            row["count"] += 1
            row["total_ns"] += s.duration
            row["self_ns"] += self.self_ns(i, kids.get(i, []))
        return out


class _Recorder:
    """The state of the tracing block that is open (one per process: spans
    open at call sites all through the port)."""

    def __init__(self):
        self.on = False
        self.host: list = []  # [name, start, end, parent, step, first stamp, end stamp]
        self.open: list[int] = []
        self.step = 0
        self.step_depth = 0
        self.launched = 0  # device stamps launched in this block
        self.device: torch.device | None = None
        self.cpu_ring: list = []
        self.counted: set = set()  # devices whose respawn counter was handed out
        self.live_calls: dict = {}  # site -> count_live_pairs calls in this block


_REC = _Recorder()
SITES: dict[str, int] = {}  # device span name -> site; never renumbered (graphs hold the codes)
# CUDA device index -> (ring, count); kept for the process: graphs hold their addresses
_RINGS: dict[int, tuple] = {}
# device -> int64 [2] counter of RESPAWNS (respawned, scored); kept likewise
_RESPAWN_COUNTS: dict[str, torch.Tensor] = {}
_LIB = []


def is_tracing() -> bool:
    return _REC.on


class _HostSpan:
    __slots__ = ("name", "timer", "step", "index", "timed", "annotation")

    def __init__(self, name, timer, step):
        self.name, self.timer, self.step = name, timer, step
        self.timed = self.annotation = None

    def __enter__(self):
        if self.timer is not None:
            self.timed = self.timer(self.name)
            self.timed.__enter__()
        r = _REC
        if self.step:
            if r.step_depth == 0:
                r.step += 1
            r.step_depth += 1
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.autograd.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.index = len(r.host)
        r.host.append([self.name, time.perf_counter_ns(), 0, r.open[-1] if r.open else None,
                       r.step, r.launched, 0])
        r.open.append(self.index)
        return self

    def __exit__(self, *exc):
        r = _REC
        rec = r.host[self.index]
        rec[2], rec[6] = time.perf_counter_ns(), r.launched
        r.open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        if self.step:
            r.step_depth -= 1
        if self.timed is not None:
            self.timed.__exit__(*exc)
        return False


def span(name: str, timer=None, step: bool = False):
    """A host span named ``name`` (module docstring); ``step=True`` starts
    the next step.  ``timer(name)``, a context manager such as the learner's
    ``PhaseTimer``, also times the block, tracing on or off (its own work --
    a synchronize -- falls outside the span)."""
    if not _REC.on:
        return _NULL if timer is None else timer(name)
    return _HostSpan(name, timer, step)


class _DeviceSpan:
    __slots__ = ("code", "device")

    def __init__(self, code, device):
        self.code, self.device = code, device

    def __enter__(self):
        _stamp(self.code, self.device)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            _stamp(self.code + 1, self.device)
        return False


def device_span(name: str, device):
    """A device span named ``name`` around the work the block puts on
    ``device``'s current stream (module docstring); a shared no-op with
    tracing off."""
    if not _REC.on:
        return _NULL
    code = SITES.setdefault(name, len(SITES))
    return _DeviceSpan(2 * code, torch.device(device))


def _stamp_lib():
    if not _LIB:
        from gym_puzzles_tpu_torch.engine import _cuda_build as cb

        vp = ctypes.c_void_p
        _LIB.append(cb.load_plain("stamp", "stamp.cu", {
            "gpt_stamp": ([vp, vp, ctypes.c_ulonglong, ctypes.c_longlong, vp], ctypes.c_int)}))
    return _LIB[0]


def _ring(device: torch.device) -> tuple:
    held = _RINGS.get(device.index)
    if held is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the span ring is made outside a CUDA graph capture: a graph's "
                               "eager warm-up stamps first")
        held = (torch.zeros((2 * RING_CAPACITY,), dtype=torch.int64, device=device),
                torch.zeros((1,), dtype=torch.int64, device=device))
        torch.cuda.synchronize(device)
        _RINGS[device.index] = held
    return held


def _on_device(device: torch.device) -> torch.device:
    """The block's device, set by its first stamp: one per block."""
    r = _REC
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if r.device is None:
        r.device = device
    elif r.device != device:
        raise ValueError(f"a tracing block stamps one device: {r.device}, then {device}")
    return device


def _stamp(code: int, device: torch.device):
    r = _REC
    device = _on_device(device)
    if device.type == "cuda":
        ring, count = _ring(device)
        err = _stamp_lib().gpt_stamp(ring.data_ptr(), count.data_ptr(), RING_CAPACITY, code,
                                     torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"the span stamp's launch failed: CUDA error {err}")
    else:
        r.cpu_ring.append((code, time.perf_counter_ns()))
    r.launched += 1


def count_live_pairs(table, state, dt: float, site: str = "ppo.update",
                     every: int = 1) -> LivePairRecord | None:
    """With tracing on, append to :data:`LIVE_PAIRS` the load kernel A
    meets at the next tick from ``state`` (an ``EnvState``): every dynamic
    body woken, as a step's control wakes the block and each commanded
    agent, and no force.  The record is marked with ``site``, and taken at
    every ``every``-th call from that site in the open tracing block (None
    from the others).  Its ops run eagerly where they are called: call it
    outside any CUDA graph capture and outside the spans that time a layer.
    With tracing off it does nothing and returns None."""
    if not _REC.on:
        return None
    calls = _REC.live_calls[site] = _REC.live_calls.get(site, 0) + 1
    if calls % every:
        return None
    from gym_puzzles_tpu_torch.engine import _cuda_build as cb
    from gym_puzzles_tpu_torch.engine import step_cuda

    bodies = state.bodies
    dyn = torch.as_tensor(~table.is_static, device=bodies.awake.device)[:, None]
    live = cb.live_pairs(table, bodies, state.contacts, torch.zeros_like(bodies.vel),
                         torch.zeros_like(bodies.omega), dyn.expand_as(bodies.awake), dt)
    per_warp = step_cuda.KERNEL.envs_per_warp() if live.is_cuda else 1
    st = cb.live_pair_stats(live, per_warp)
    rec = LivePairRecord(num_envs=int(live.shape[-1]), mean=st["mean"],
                         warp_max=st["warp_max"], max=st["max"], envs_per_warp=per_warp,
                         size_class=cb.size_class(table), site=site)
    LIVE_PAIRS.append(rec)
    return rec


def respawn_counts(device) -> torch.Tensor | None:
    """With tracing on, the int64 [2] counter on ``device`` that the v0 env's
    ``score_respawn`` kernel adds to (envs respawned, env-steps scored; a
    graph captured with tracing on holds its address), read into
    :data:`RESPAWNS` and set to 0 when the tracing block ends.  None with
    tracing off: the kernel then counts nothing."""
    if not _REC.on:
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _REC.counted.add(str(device))
    held = _RESPAWN_COUNTS.get(str(device))
    if held is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the respawn counter is made outside a CUDA graph capture: a "
                               "graph's eager warm-up counts first")
        held = _RESPAWN_COUNTS[str(device)] = torch.zeros((2,), dtype=torch.int64,
                                                          device=device)
    return held


def launched() -> int:
    """Device stamps launched so far in the open tracing block."""
    return _REC.launched


def advance(n: int, device):
    """Count ``n`` stamps launched on ``device`` by a CUDA graph replay (a
    negative ``n`` takes back those a capture recorded without running
    them)."""
    if n:
        _on_device(torch.device(device))
        _REC.launched += n


@contextlib.contextmanager
def tracing():
    """Record spans over the block; yields the :class:`Trace`, filled in
    when the block ends (after a synchronize and one copy of the ring)."""
    r = _REC
    if r.on:
        raise RuntimeError("tracing is on already")
    for index, (_ring_t, count) in _RINGS.items():
        torch.cuda.synchronize(index)
        count.zero_()
        torch.cuda.synchronize(index)
    r.__init__()
    out = Trace()
    r.on = True
    try:
        yield out
    except BaseException:
        for _device, counts in _respawn_counters(r):
            counts.zero_()
        r.__init__()  # what the block recorded is incomplete: dropped
        raise
    r.on = False
    try:
        _fill(out, r)
        for device, counts in _respawn_counters(r):
            respawned, scored = counts.tolist()  # a host read: after the block's work
            counts.zero_()
            if scored:
                RESPAWNS.append(RespawnRecord(device, respawned, scored))
    finally:
        r.__init__()


def _respawn_counters(r: _Recorder) -> list:
    """(device, counter) of the respawn counters the block may have added
    to: those handed out in it, and its stamps' device's (a graph captured
    with tracing on adds to its counter at each replay).  A block on the CPU
    touches no counter on the card."""
    devices = set(r.counted) | ({str(r.device)} if r.device is not None else set())
    return [(d, _RESPAWN_COUNTS[d]) for d in sorted(devices) if d in _RESPAWN_COUNTS]


def _fill(out: Trace, r: _Recorder):
    """The block's host records and device stamps -> ``out``."""
    if r.device is not None and r.device.type == "cuda":
        ring, count = _RINGS[r.device.index]
        torch.cuda.synchronize(r.device)
        n = int(count.item())
        kept = min(n, RING_CAPACITY)
        rows = ring[:2 * kept].view(kept, 2).cpu().numpy()
    else:
        n = kept = len(r.cpu_ring)
        rows = np.asarray(r.cpu_ring, dtype=np.int64).reshape(-1, 2)
    if n != r.launched:
        raise RuntimeError(f"{n} device stamps ran, {r.launched} were launched")
    out.stamps, out.dropped, out.device = n, n - kept, r.device
    out._stamp_times = rows[:, 1].copy()
    out.steps = r.step
    out.spans = [Span(name, "host", start, end, parent, step)
                 for name, start, end, parent, step, _lo, _hi in r.host]
    # the innermost host span open when each stamp was launched
    owner = np.full((kept,), -1, dtype=np.int64)
    for i, rec in enumerate(r.host):
        owner[rec[5]:rec[6]] = i
    names = {code: name for name, code in SITES.items()}
    stack = []
    for pos, (code, t) in enumerate(rows.tolist()):
        if code % 2 == 0:
            if stack:
                parent = stack[-1]
            else:
                parent = int(owner[pos]) if owner[pos] >= 0 else None
            step = out.spans[parent].step if parent is not None else 0
            stack.append(len(out.spans))
            out._edges[len(out.spans)] = (pos, pos)
            out.spans.append(Span(names[code // 2], "device", t, t, parent, step))
        else:
            index = stack.pop()
            s = out.spans[index]
            if SITES[s.name] != code // 2:
                raise RuntimeError(f"device span {names[code // 2]} ended inside {s.name}")
            s.end = t
            out._edges[index] = (out._edges[index][0], pos)


# --------------------------------------------------------------------------
# One clock with the profiler's trace
# --------------------------------------------------------------------------


def _line(x, y) -> tuple:
    """Least squares ``y ~ a + b * (x - x[0])`` -> (a, b, max |residual|)."""
    x = np.asarray(x, np.float64) - x[0]
    y = np.asarray(y, np.float64)
    b, a = np.polyfit(x, y, 1) if len(x) > 1 else (1.0, float(y[0]))
    return float(a), float(b), float(np.abs(y - (a + b * x)).max())


def fit_clocks(out: Trace, events: list) -> dict:
    """The program's clocks against the profiler's (its ``ts``, us): each
    device stamp (ring order) matched to its kernel in the trace (trace
    order), each host span to its ``record_function`` range (in order, by
    name).  -> {"device_stamps": stamps matched (0 unless the counts agree),
    "device_rate": trace us per device us of the line fitted through them,
    "device_residual_us": the largest distance of a stamp from that line,
    "device_offset_residual_us": from a constant offset instead,
    "host_spans", "host_residual_us": the same for the host spans}.  The
    matched times are kept on ``out`` for :func:`span_events`."""
    fit = {"device_stamps": 0, "device_rate": None, "device_residual_us": None,
           "device_offset_residual_us": None, "host_spans": 0, "host_residual_us": None}
    kernels = sorted(float(e["ts"]) for e in events
                     if e.get("cat") == "kernel" and STAMP_KERNEL in e.get("name", ""))
    times = out._stamp_times * 1e-3
    out._device_ts = out._host_ts = None
    if out.device is not None and out.device.type == "cuda" and kernels and \
            len(kernels) == len(times):
        _a, rate, res = _line(times, kernels)
        d = np.asarray(kernels) - times
        fit.update(device_stamps=len(kernels), device_rate=rate, device_residual_us=res,
                   device_offset_residual_us=float(np.abs(d - np.median(d)).max()))
        out._device_ts = kernels
    by_name: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            by_name.setdefault(e["name"], []).append((float(e["ts"]), float(e["dur"])))
    host_ts, mine, theirs = {}, [], []
    for name in {s.name for s in out.spans if s.clock == "host"}:
        idx = [i for i, s in enumerate(out.spans) if s.clock == "host" and s.name == name]
        marks = sorted(by_name.get(name, []))
        if len(marks) == len(idx):
            host_ts.update(zip(idx, marks))
            mine += [out.spans[i].start * 1e-3 for i in idx]
            theirs += [m[0] for m in marks]
    if mine:
        order = np.argsort(mine)
        x = np.asarray(mine)[order]
        a, b, res = _line(x, np.asarray(theirs)[order])
        fit.update(host_spans=len(mine), host_residual_us=res)
        out._host_ts = host_ts
        if out.device is not None and out.device.type == "cpu" and len(times):
            # one clock on the CPU: the device stamps follow the host's line
            out._device_ts = list(a + b * (times - x[0]))
            fit["device_stamps"] = len(times)
    return fit


def _placed(out: Trace) -> list:
    """(trace start us, trace end us, span index) of each span placed on the
    profiler's clock by :func:`fit_clocks`' matches."""
    rows = []
    if out._host_ts:
        rows += [(ts, ts + dur, i) for i, (ts, dur) in out._host_ts.items()]
    if out._device_ts is not None:
        rows += [(out._device_ts[b], out._device_ts[e], i) for i, (b, e) in out._edges.items()]
    return sorted(rows)


def span_events(out: Trace) -> list:
    """The program's spans as Chrome trace rows on the profiler's clock (the
    spans :func:`fit_clocks` matched)."""
    return [{"ph": "X", "cat": "program_span", "name": out.spans[i].name,
             "pid": "program spans", "tid": out.spans[i].clock, "ts": a, "dur": b - a,
             "args": {"index": i, "parent": out.spans[i].parent, "step": out.spans[i].step}}
            for a, b, i in _placed(out)]


def idle_by_span(out: Trace, events: list) -> list:
    """The device's idle time over the block (from its first host span's
    start to its last's end), put down to the innermost host span open at
    each moment of each gap (:data:`NO_SPAN` outside all): [[name, seconds]],
    longest first."""
    depth = []
    for s in out.spans:
        depth.append(0 if s.parent is None else depth[s.parent] + 1)
    spans = [(a, b, depth[i], out.spans[i].name) for a, b, i in _placed(out)
             if out.spans[i].clock == "host"]
    if not spans:
        return []
    lo = min(a for a, _b, _d, _n in spans)
    hi = max(b for _a, b, _d, _n in spans)
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") in DEVICE_OPS and e.get("ph") == "X")
    gaps, end = [], lo
    for a, b in ops:
        if a > end and end < hi:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    starts = [s[0] for s in spans]
    by: dict = {}
    for a, b in gaps:
        near = [s for s in spans[:bisect.bisect_left(starts, b)] if s[1] > a]
        cuts = sorted({a, b} | {x for s in near for x in s[:2] if a < x < b})
        for x, y in zip(cuts[:-1], cuts[1:]):
            mid = 0.5 * (x + y)
            inside = [s for s in near if s[0] <= mid < s[1]]
            name = max(inside, key=lambda s: (s[2], s[0]))[3] if inside else NO_SPAN
            by[name] = by.get(name, 0.0) + (y - x) * 1e-6
    return sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])


def launch_extents(out: Trace, events: list) -> dict:
    """{host span name: us}: for each host span placed by :func:`fit_clocks`,
    the device time from the start of the first device op launched inside
    it to the end of the last (ops matched to their launch calls by the
    trace's correlation ids), summed over the spans of that name.  A graph
    replay's extent is its kernels' first start to last end, idle inside
    included."""
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    ops = sorted((launch[e["args"]["correlation"]], float(e["ts"]),
                  float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") in DEVICE_OPS and e.get("ph") == "X"
                 and e.get("args", {}).get("correlation") in launch)
    starts = [o[0] for o in ops]
    by: dict = {}
    for i, (ts, dur) in (out._host_ts or {}).items():
        inside = ops[bisect.bisect_left(starts, ts):bisect.bisect_right(starts, ts + dur)]
        if inside:
            name = out.spans[i].name
            by[name] = by.get(name, 0.0) + max(o[2] for o in inside) - min(o[1] for o in inside)
    return by


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(profile_dir: str | None):
    """Profile the enclosed block with tracing on when ``profile_dir`` is set
    (the module docstring: ``<profile_dir>/trace.json``, for chrome://tracing
    or Perfetto, holds the profiler's events and the program's spans on its
    clock); a no-op otherwise.  Yields the :class:`Trace` (its ``profiler``
    for ``key_averages()``; its ``fit``, ``idle``, ``device_us`` and
    ``extents`` once the block has ended), or None.

        with profiling.trace("/tmp/tb") as tr:
            env.step(...)
        print(tr.fit, tr.idle)
    """
    if not profile_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with tracing() as out:
            out.profiler = prof
            yield out
            _sync()
    path = Path(profile_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))
    data = json.loads((path / "trace.json").read_text())
    events = data["traceEvents"]
    out.fit = fit_clocks(out, events)
    out.idle = idle_by_span(out, events)
    out.device_us = sum(float(e["dur"]) for e in events
                        if e.get("cat") in DEVICE_OPS and e.get("ph") == "X")
    out.extents = launch_extents(out, events)
    events += span_events(out)
    (path / "trace.json").write_text(json.dumps(data))


def traced_calls(fn, steps: int, profiled: int, profile_dir: str) -> tuple:
    """``fn(k)`` with tracing on, as the per-layer readings take it: once
    (k = 0), which captures any CUDA graph anew with the stamps inside; then
    ``steps`` calls timed to a synchronize with the profiler off; then
    ``profiled`` more under :func:`trace` into ``profile_dir``.  -> (the
    timed calls' :class:`Trace`, their wall seconds, the profiled calls'
    :class:`Trace`)."""
    with tracing():
        fn(0)
    with tracing() as timed:
        _sync()
        t0 = time.perf_counter()
        for k in range(1, steps + 1):
            fn(k)
        _sync()
        wall_s = time.perf_counter() - t0
    with trace(profile_dir) as profiled_trace:
        for k in range(steps + 1, steps + 1 + profiled):
            fn(k)
    return timed, wall_s, profiled_trace


# --------------------------------------------------------------------------
# Determinism
# --------------------------------------------------------------------------


def _leaves(x):
    """The tensor and array leaves of a tree of tuples, lists, dicts and
    dataclasses, in order, as numpy arrays on the host."""
    if dataclasses.is_dataclass(x):
        return [leaf for f in dataclasses.fields(x) for leaf in _leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [leaf for k in x for leaf in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    if isinstance(x, torch.Tensor):
        return [x.detach().cpu().numpy()]
    return [np.asarray(x)]


def assert_deterministic(fn, *args, n: int = 2):
    """Determinism check: run ``fn(*args)`` ``n`` times, each after a device
    synchronise, and assert that the outputs' leaves are bitwise equal.
    Returns the first result."""
    results = []
    for _ in range(n):
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        results.append(out)
    first = _leaves(results[0])
    for r in results[1:]:
        other = _leaves(r)
        if len(other) != len(first):
            raise AssertionError(f"{len(first)} outputs, then {len(other)}")
        for a, b in zip(first, other):
            np.testing.assert_array_equal(a, b)
    return results[0]
