"""CUDA graphs of the port's step functions: the counterpart of the JAX
package's ``jax.jit`` around its env step (``api/vector.py:111,117``), its
image env step (``api/image_obs.py:135,143``), its rollout scan
(``train/ppo.py:271-337``) and the rest of its train step (``train/ppo.py:
339-470``: bootstrap value, GAE, minibatch epochs, metrics).

:class:`GraphedStep` wraps an eager function ``fn(carry, *args) -> (carry,
*outs)`` whose ``carry`` comes out with the structure it went in with (an env
state, a learner's rollout state, its params and Adam state).  At its first
call on a CUDA device it

1. copies the tensor leaves of ``args`` into static buffers, and each
   :class:`~gym_puzzles_tpu_torch.engine.types.DeviceScalars` dataclass among
   them (``RewardParams``, the learner's ``HParams``) into a small float32
   buffer whose 0-d views the function reads in place of the Python floats
   (so that a changed value reaches the next replay with no re-capture);
2. runs ``fn`` once eagerly on a side stream (torch's warm-up: kernel
   libraries load, cuDNN and cuBLAS pick their algorithms, the world table
   reaches constant memory, the step path's host constants reach the card, a
   process group makes its communicator), then puts back the states of the
   ``generators`` it drew from, the kernels' launch counts and the
   ``counters``' calls;
3. captures ``fn`` on the static buffers into one graph, with the
   ``generators`` registered so that each replay draws the numbers eager
   calls would have drawn, and copies its outputs into one flat static
   buffer, whose carry part is also the next replay's carry input.

Each call then copies in the inputs that changed (one multi-tensor copy per
dtype; a leaf that is the tensor last copied or returned there, unchanged
since by its version counter, is not copied), re-uploads each world table the
graph's kernels read if another table was uploaded since (each kernel library
has one ``__constant__`` table), replays, adds the launches the graph holds
to each kernel's count and the calls it holds to each counter, and returns
the outputs as views into one clone of the flat buffer: what a call returned
is never changed by a later call, as in JAX.

A replay writes its buffers without bumping any tensor's version counter,
so a buffer that one graph fills and another reads (the rollout's
``Transition``, which the learner's graph reads) must reach the second
function through its closure, never through an argument: an argument slot
would see the same tensor at the same version and skip the copy.

Tracing (``utils/profiling.py``) is part of a graph's signature: a graph
captured with tracing off holds no stamp and no op of it; the first call with
tracing on captures anew, with the device spans' stamps inside, whose count
each replay adds to the stamps launched.  A call's host time is split into the
host spans ``graph.inputs`` (flatten, signature, copy-in, table re-upload;
``graph.capture`` inside it when the call captures), ``graph.launch`` (the
replay) and ``graph.outputs`` (the clone and unflatten).  Each capture is
counted, tracing on or off (``profiling.CAPTURES``): its name, the seconds of
its warm-up and capture, and the kernel nodes of the graph.

Anything that cannot be captured -- a host read, a host-to-device copy from
pageable memory, a world table not uploaded, a collective staged through the
host -- raises at capture with CUDA's or PyTorch's reason.  A non-tensor leaf
of the inputs (a ``NormalizerState.gamma``) is part of the graph's signature:
a call with another value, or with other shapes, captures anew.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import time
import weakref

import torch

from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.engine.types import DeviceScalars
from gym_puzzles_tpu_torch.envs.config import RewardParams
from gym_puzzles_tpu_torch.utils import profiling

ALIGN = 512  # the caching allocator's alignment: reductions read the same layout


# --------------------------------------------------------------------------
# Trees of tensors
# --------------------------------------------------------------------------


def flatten(tree) -> tuple[list, tuple]:
    """-> (leaves, spec).  Leaves are tensors and ``DeviceScalars``; dataclasses,
    dicts, lists and tuples are walked; anything else is a static value kept
    in ``spec``.  Two trees with equal specs have leaves of equal shape and
    dtype, in the same places."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _walk(x, leaves: list):
    # not a closure: a recursive inner function would hold itself and the
    # leaves in a reference cycle, alive until the cyclic collector runs
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, DeviceScalars):
        leaves.append(x)
        return ("params", type(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return ("dataclass", type(x), names, tuple(_walk(getattr(x, n), leaves) for n in names))
    if isinstance(x, dict):
        return ("dict", tuple(x), tuple(_walk(v, leaves) for v in x.values()))
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_walk(v, leaves) for v in x))
    return ("static", x)


def unflatten(spec, leaves):
    """The tree of ``spec`` with ``leaves`` (an iterable) in its leaf places."""
    return _build(spec, iter(leaves))


def _build(s, it):
    kind = s[0]
    if kind in ("tensor", "params"):
        return next(it)
    if kind == "dataclass":
        return s[1](**{n: _build(c, it) for n, c in zip(s[2], s[3])})
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(s[1], s[2])}
    if kind == "static":
        return s[1]
    return kind(_build(c, it) for c in s[1])


def _strides(t: torch.Tensor) -> tuple:
    """``t``'s strides if it is dense and non-overlapping (a permuted
    contiguous tensor, e.g. an obs returned as ``obs.T``), else contiguous
    strides: the static copy keeps the layout the eager function saw."""
    expected = 1
    for d in sorted(range(t.dim()), key=t.stride):
        if t.shape[d] == 1:
            continue
        if t.stride(d) != expected:
            return torch.empty(t.shape, device="meta").stride()
        expected *= t.shape[d]
    return t.stride()


class FlatBuffer:
    """Tensors of the given shapes, dtypes and strides laid out in one buffer
    per dtype on ``device`` (so that ``torch.save`` takes the views), each
    view aligned to ``ALIGN`` bytes."""

    def __init__(self, like: list, device):
        self.layout, sizes = [], {}
        for t in like:
            offset = sizes.get(t.dtype, 0)
            self.layout.append((t.dtype, offset, tuple(t.shape), _strides(t)))
            step = ALIGN // t.element_size()
            sizes[t.dtype] = offset + -(-t.numel() // step) * step
        self.buffers = {dtype: torch.empty((max(n, 1),), dtype=dtype, device=device)
                        for dtype, n in sizes.items()}
        self.views = self.views_of(self.buffers)

    def views_of(self, buffers: dict) -> list:
        """The leaf views into ``buffers`` (this layout's, or their clones)."""
        return [buffers[dtype].as_strided(shape, strides, offset)
                for dtype, offset, shape, strides in self.layout]

    def snapshot(self) -> list:
        """The leaves as views into one clone of each buffer."""
        return self.views_of({dtype: b.clone() for dtype, b in self.buffers.items()})

    def holds(self, t: torch.Tensor) -> bool:
        for b in self.buffers.values():
            start = b.data_ptr()
            if start <= t.data_ptr() < start + b.numel() * b.element_size():
                return True
        return False


class ParamsBuffer:
    """One ``DeviceScalars`` dataclass of type ``cls`` (default
    ``RewardParams``) as a float32 device buffer; :attr:`view` has a 0-d view
    of it in each field."""

    def __init__(self, device, cls=RewardParams):
        self.fields = tuple(f.name for f in dataclasses.fields(cls))
        self.buffer = torch.empty((len(self.fields),), dtype=torch.float32, device=device)
        self.view = cls(*self.buffer.unbind(0))
        self.values = None

    def load(self, params: DeviceScalars):
        values = tuple(float(getattr(params, f)) for f in self.fields)
        if values != self.values:  # NaN never equals itself: copied again, harmlessly
            host = torch.tensor(values, dtype=torch.float32)
            # from pinned memory the copy does not wait for the card (PyTorch
            # keeps the pinned block until the copy has run)
            self.buffer.copy_(host.pin_memory() if self.buffer.is_cuda else host,
                              non_blocking=True)
            self.values = values


def as_device_scalars(x: DeviceScalars, device) -> DeviceScalars:
    """``x`` with its fields as 0-d float32 views of one buffer on
    ``device``, as a graph reads it; ``x`` itself when its fields are
    tensors already (a graph's views)."""
    if all(isinstance(getattr(x, f.name), torch.Tensor) for f in dataclasses.fields(x)):
        return x
    buf = ParamsBuffer(device, type(x))
    buf.load(x)
    return buf.view


# --------------------------------------------------------------------------
# The graph
# --------------------------------------------------------------------------


def weak_call(method):
    """A function that calls the bound ``method`` through a weak reference to
    its object: a graph its object holds does not keep the object alive, so
    the object, its graph and the graph's memory go when the last reference
    to the object does (not at some later garbage collection)."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        return ref()(*args)

    return call


class _Slot:
    """A static input: its buffer view, and the tensor (weakly) and version
    its content came from."""

    __slots__ = ("view", "source", "version")

    def __init__(self, view):
        self.view, self.source, self.version = view, None, -1

    def stale(self, t: torch.Tensor) -> bool:
        """Whether the view does not hold ``t``'s content by the record: ``t``
        is another tensor, or its version moved."""
        return self.source is None or self.source() is not t or t._version != self.version

    def load(self, t: torch.Tensor):
        if self.stale(t):
            self.view.copy_(t)
            self.hold(t)

    def hold(self, t: torch.Tensor):
        self.source, self.version = weakref.ref(t), t._version


def _load_slots(slots, values):
    """Copy each value whose slot is stale into it: one multi-tensor copy
    per dtype (``ParamsBuffer`` leaves load their own buffer)."""
    by_dtype: dict = {}
    for slot, x in zip(slots, values):
        if isinstance(slot, ParamsBuffer):
            slot.load(x)
        elif slot.stale(x):
            dsts, srcs = by_dtype.setdefault(slot.view.dtype, ([], []))
            dsts.append(slot.view)
            srcs.append(x)
            slot.hold(x)
    for dsts, srcs in by_dtype.values():
        torch._foreach_copy_(dsts, srcs)


@dataclasses.dataclass
class _Capture:
    graph: torch.cuda.CUDAGraph
    signature: tuple
    out_spec: tuple
    n_carry: int
    carry_slots: list
    arg_slots: list  # _Slot or ParamsBuffer per leaf of args
    out_buffer: FlatBuffer
    launches: dict  # kernel name -> launches per replay
    calls: list  # per counter, the calls per replay
    worlds: list  # (CudaKernel, ShapeTable) whose table the graph's launches read
    stamps: int  # the spans' device stamps per replay (0 unless captured with tracing on)


_CU_GRAPH_NODE_TYPE_KERNEL = 0


def graph_nodes(graph: torch.cuda.CUDAGraph) -> tuple[int, int]:
    """(kernel nodes, all nodes) of a graph captured with ``keep_graph=True``,
    read through the driver (``cuGraphGetNodes``, ``cuGraphNodeGetType``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    vp, size = ctypes.c_void_p, ctypes.c_size_t
    cuda.cuGraphGetNodes.argtypes = [vp, ctypes.POINTER(vp), ctypes.POINTER(size)]
    cuda.cuGraphGetNodes.restype = ctypes.c_int
    cuda.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    cuda.cuGraphNodeGetType.restype = ctypes.c_int
    handle, n = vp(graph.raw_cuda_graph()), size(0)
    err = cuda.cuGraphGetNodes(handle, None, ctypes.byref(n))
    nodes = (vp * n.value)()
    err = err or cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        err = err or cuda.cuGraphNodeGetType(node, ctypes.byref(kind))
        kernels += kind.value == _CU_GRAPH_NODE_TYPE_KERNEL
    if err != 0:
        raise RuntimeError(f"reading a CUDA graph's nodes failed: CUDA driver error {err}")
    return kernels, n.value


class GraphedStep:
    """``fn(carry, *args) -> (carry, *outs)`` replayed as one CUDA graph on
    ``device`` (module docstring).  ``generators`` are the CUDA generators
    ``fn`` draws from; ``pool`` a memory pool shared with other graphs of
    the same owner (``torch.cuda.graph_pool_handle()``), replayed one at a
    time on one stream.  ``counters`` are objects whose ``calls`` attribute
    counts host-side calls ``fn`` makes (a mesh's all-reduces): each replay
    adds the calls its capture made.  ``name`` names its captures in
    ``profiling.CAPTURES``."""

    def __init__(self, fn, device, generators=(), pool=None, counters=(), name: str = "graph"):
        self.fn = fn
        self.name = name
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph runs on a CUDA device, got {self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.generators = tuple(generators)
        self.counters = tuple(counters)
        self.pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        self._cap: _Capture | None = None
        self.captures = 0  # graphs captured so far: one per signature change

    @property
    def launches(self) -> dict:
        """Kernel launches per replay, by kernel name ({} before the first call)."""
        return dict(self._cap.launches) if self._cap is not None else {}

    def close(self):
        """Release the graph (its memory goes back with the pool)."""
        self._cap = None

    def __call__(self, carry, *args):
        with torch.cuda.device(self.device):
            with profiling.span("graph.inputs"):
                carry_leaves, carry_spec = flatten(carry)
                arg_leaves, arg_spec = flatten(args)
                signature = (carry_spec, arg_spec, profiling.is_tracing())
                if self._cap is None or self._cap.signature != signature:
                    self._cap = None  # the old graph's memory returns to the pool first
                    with profiling.span("graph.capture"):
                        self._cap = self._capture(carry, args, signature)
                    self.captures += 1
                cap = self._cap
                _load_slots(cap.carry_slots + cap.arg_slots, carry_leaves + arg_leaves)
                stream = torch.cuda.current_stream(self.device).cuda_stream
                for kernel, table in cap.worlds:
                    kernel.set_world(table, self.device, stream)
            with profiling.span("graph.launch"):
                cap.graph.replay()
                profiling.advance(cap.stamps, self.device)
            with profiling.span("graph.outputs"):
                for name, n in cap.launches.items():
                    cb.KERNELS[name].launches += n
                for counter, n in zip(self.counters, cap.calls):
                    counter.calls += n
                snap = cap.out_buffer.snapshot()
                for slot, t in zip(cap.carry_slots, snap[:cap.n_carry]):
                    slot.hold(t)
                return unflatten(cap.out_spec, snap)

    # ------------------------------------------------------------------
    def _capture(self, carry, args, signature) -> _Capture:
        dev = self.device
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            carry_leaves, carry_spec = flatten(carry)
            arg_leaves, arg_spec = flatten(args)
            tensors = [x for x in arg_leaves if isinstance(x, torch.Tensor)]
            arg_buffer = FlatBuffer(tensors, dev) if tensors else None
            views = iter(arg_buffer.views if arg_buffer else ())
            arg_slots = [_Slot(next(views)) if isinstance(x, torch.Tensor)
                         else ParamsBuffer(dev, type(x)) for x in arg_leaves]
            _load_slots(arg_slots, arg_leaves)
            static_args = unflatten(arg_spec, [s.view for s in arg_slots])

            # warm-up on a side stream; the generators, launch counts and
            # counters as before
            gen_states = [g.get_state() for g in self.generators]
            counts = {name: k.launches for name, k in cb.KERNELS.items()}
            calls = [c.calls for c in self.counters]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                warm = self.fn(carry, *static_args)
            torch.cuda.current_stream(dev).wait_stream(side)
            warm_leaves, out_spec = flatten(warm)
            if flatten(warm[0])[1] != carry_spec:
                raise ValueError("the function's carry came out with another structure, "
                                 "shape or dtype than it went in with")
            if any(not isinstance(x, torch.Tensor) for x in warm_leaves):
                raise ValueError("a graphed function's outputs hold tensors only")
            n_carry = len(carry_leaves)
            out_buffer = FlatBuffer(warm_leaves, dev)
            del warm, warm_leaves
            carry_slots = [_Slot(v) for v in out_buffer.views[:n_carry]]
            for slot, t in zip(carry_slots, carry_leaves):
                slot.load(t)
            static_carry = unflatten(carry_spec, [s.view for s in carry_slots])
            for g, state in zip(self.generators, gen_states):
                g.set_state(state)
            for c, n in zip(self.counters, calls):
                c.calls = n
            torch.cuda.synchronize(dev)
            before = {name: k.launches for name, k in cb.KERNELS.items()}

            stamps0 = profiling.launched()
            graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept to count its nodes
            for g in self.generators:
                graph.register_generator_state(g)
            # Another graph destroyed during the capture (the cyclic garbage
            # collector finalizing an old env) would end it: collect first,
            # and not while capturing.
            gc.collect()
            gc_was_enabled = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool):
                    res = flatten(self.fn(static_carry, *static_args))
                    if res[1] != out_spec:
                        raise ValueError("the captured function's outputs differ from its "
                                         "warm-up's")
                    outs = [x.clone() if out_buffer.holds(x) and x is not v else x
                            for x, v in zip(res[0], out_buffer.views)]
                    for v, x in zip(out_buffer.views, outs):
                        v.copy_(x)
                    del res, outs
            finally:
                if gc_was_enabled:
                    gc.enable()
            # the capture's stamps did not run: each replay adds them
            stamps = profiling.launched() - stamps0
            profiling.advance(-stamps, dev)
            graph.instantiate()
            seconds = time.perf_counter() - t0
            launches = {name: k.launches - before[name] for name, k in cb.KERNELS.items()
                        if k.launches != before[name]}
            index = dev.index
            worlds = [(k, k.uploaded[index][0]) for k in map(cb.KERNELS.get, launches)
                      if isinstance(k, cb.CudaKernel)]
            for name, k in cb.KERNELS.items():
                k.launches = counts.get(name, 0)
            per_replay = [c.calls - n for c, n in zip(self.counters, calls)]
            for c, n in zip(self.counters, calls):
                c.calls = n
        kernel_nodes, nodes = graph_nodes(graph)
        profiling.CAPTURES.append(profiling.CaptureRecord(self.name, seconds, kernel_nodes,
                                                          nodes, signature[-1]))
        return _Capture(graph=graph, signature=signature, out_spec=out_spec, n_carry=n_carry,
                        carry_slots=carry_slots, arg_slots=arg_slots, out_buffer=out_buffer,
                        launches=launches, calls=per_replay, worlds=worlds, stamps=stamps)
