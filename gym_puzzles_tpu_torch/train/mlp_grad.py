"""The MLP learner's per-minibatch gather, forward, PPO loss and backward as
a chain of hand-written CUDA kernels around the trunk's three large GEMMs
(``csrc/mlp_grad.cu``): its wrapper, grid and binding.

One call computes what ``PPO.loss`` followed by ``torch.autograd.grad``
computes for an :class:`~gym_puzzles_tpu_torch.train.networks.ActorCritic`
with a two-layer tanh trunk, on the minibatch rows ``idx`` of the flat batch:
the gradient of every leaf, in ``params`` order, the four losses (total,
policy, value, entropy) and ``approx_kl``.  It runs as seven launches: the
kernels ``fwd`` (gather, layer 1, the advantages' partial sums), ``head``
(layer 2's tanh, the heads, the loss and its gradient down to dz2),
``back`` (layer 1's tanh backward, dW1 and db1) and ``reduce`` (every
partial sum, in one fixed order), around cuBLAS's ``z2 = h1 W2^T``,
``dW2 = dz2^T h1`` and ``dh1 = dz2 W2`` (``torch.mm``, float32).

* Build, binding and launch count: ``engine/_cuda_build.py`` (a
  :class:`~gym_puzzles_tpu_torch.engine._cuda_build.PlainKernel`: a call adds
  4 launches, and a CUDA graph that captured it adds 4 per replay).
* Who takes it: ``PPO`` on a CUDA device for a network :func:`takes`
  (``train/ppo.py`` ``PPO.minibatch_steps``); the CPU and every other network
  run ``PPO.loss`` and autograd, the plain version.
* The hyperparameters ``clip_range``, ``vf_coef`` and ``ent_coef`` are read on
  the card from their 0-d tensors (the learner graph's views).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.train.networks import _HALF_LOG_2PIE, _LOG_2PI, ActorCritic

# csrc/mlp_grad.cu's GPT_MLP_MAX_D, GPT_MLP_MAX_A, GPT_MLP_MAX_H
MAX_OBS, MAX_ACT, MAX_WIDTH = 64, 32, 512
# an ActorCritic's leaves, in its state_dict's order
KEYS = ("log_std", "trunk.0.weight", "trunk.0.bias", "trunk.1.weight", "trunk.1.bias",
        "mean.weight", "mean.bias", "value.weight", "value.bias")
# the pointers' order of the C entries (csrc/mlp_grad.cu enum Ptr)
PTRS = ("obs", "act", "olp", "adv", "ret", "idx",
        "log_std", "W1", "b1", "b2", "Wm", "bm", "wv", "bv",
        "clip", "vf", "ent",
        "h1", "z2", "dz2", "dh1", "part1", "part2", "part3",
        "g_log_std", "g_W1", "g_b1", "g_b2", "g_Wm", "g_bm", "g_wv", "g_bv", "losses", "kl")
# the leaves the reduce kernel writes (trunk.1.weight's gradient is a GEMM's)
GRAD_PTRS = {"log_std": "g_log_std", "trunk.0.weight": "g_W1", "trunk.0.bias": "g_b1",
             "trunk.1.bias": "g_b2", "mean.weight": "g_Wm", "mean.bias": "g_bm",
             "value.weight": "g_wv", "value.bias": "g_bv"}
STAGES = ("fwd", "head", "back", "reduce")
# blocks of each persistent kernel per SM: what an SM holds of head and back
# at the recipes' shapes.  On the H100 at v0 and Heavy-v0 two timed as the
# occupancy query's grid; one, or three and four (in waves), were slower.
BLOCKS_PER_SM = 2
# PPO.loss's float32 constants: log(2 pi), 0.5 log(2 pi e), the std's guard
CONSTS = (_LOG_2PI, _HALF_LOG_2PIE, 1e-8)

_vp, _int = ctypes.c_void_p, ctypes.c_int
_STAGE_ARGS = [ctypes.POINTER(_int), _vp, ctypes.POINTER(ctypes.c_float)]
KERNEL = cb.PlainKernel("mlp_grad", "mlp_grad.cu", {
    **{f"gpt_mlp_{s}": (_STAGE_ARGS + [_vp], _int) for s in STAGES},
    "gpt_mlp_setup": ([], _int),
    "gpt_mlp_scratch": ([ctypes.POINTER(_int), ctypes.POINTER(ctypes.c_longlong)], _int)})


def dims_of(net_or_params) -> tuple:
    """(obs_dim, hidden widths, act_dim) of an ActorCritic or of its params."""
    if isinstance(net_or_params, ActorCritic):
        trunk = [layer.weight.shape for layer in net_or_params.trunk]
        act = net_or_params.log_std.numel()
    else:
        trunk = [net_or_params[k].shape for k in sorted(net_or_params)
                 if k.startswith("trunk.") and k.endswith(".weight")]
        act = net_or_params["log_std"].numel()
    return int(trunk[0][1]), tuple(int(s[0]) for s in trunk), int(act)


def refusal(obs_dim: int, widths: tuple, act_dim: int) -> str | None:
    """Why the chain does not take a network of these shapes, or None."""
    if len(widths) != 2:
        return f"the chain takes a two-layer trunk, got {len(widths)} layers"
    if not 1 <= obs_dim <= MAX_OBS:
        return f"obs_dim {obs_dim}: the chain takes 1 to {MAX_OBS}"
    if not 1 <= act_dim <= MAX_ACT:
        return f"act_dim {act_dim}: the chain takes 1 to {MAX_ACT}"
    if not all(1 <= w <= MAX_WIDTH for w in widths):
        return f"trunk widths {widths}: the chain takes 1 to {MAX_WIDTH}"
    return None


def takes(net) -> bool:
    """Whether the chain computes ``net``'s minibatch gradients: an
    ActorCritic whose trunk has two layers within the kernels' limits."""
    return isinstance(net, ActorCritic) and refusal(*dims_of(net)) is None


def scratch(lib, dims) -> tuple:
    """(float64 words of fwd's partials, float32 words of head's and back's)."""
    out = (ctypes.c_longlong * 3)()
    if not lib.gpt_mlp_scratch(dims, out):
        raise ValueError(f"mlp_grad does not take the shapes {list(dims)}")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _setup(index: int):
    """The kernels' shared-memory limits, once per CUDA device."""
    with torch.cuda.device(index):
        err = KERNEL.load().gpt_mlp_setup()
    if err != 0:
        raise RuntimeError(f"{KERNEL.name}: setting the shared-memory limits failed: "
                           f"CUDA error {err}")


def grids(index: int) -> tuple:
    """The blocks of fwd, head and back on CUDA device ``index``:
    :data:`BLOCKS_PER_SM` a SM (the kernels cut each to its tiles of rows)."""
    return (BLOCKS_PER_SM * torch.cuda.get_device_properties(index).multi_processor_count,) * 3


def _card_stage(dev):
    lib = KERNEL.load()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _setup(index)

    def call(stage, dims, ptrs, consts):
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"gpt_mlp_{stage}")(dims, ptrs, consts, stream)
        if err != 0:
            raise RuntimeError(f"{KERNEL.name} kernel launch failed ({stage}): CUDA error {err}")
        KERNEL.launches += 1

    return lib, call, index


@torch.no_grad()
def launch(params: dict, batch: tuple, idx, hp, stage=None) -> tuple:
    """The chain on the minibatch rows ``idx`` (int64 [M]) of ``batch`` =
    (obs [N, obs_dim], action [N, act_dim], old log-prob [N], advantages [N],
    returns [N]) with ``params`` (an ActorCritic's, :data:`KEYS`) and ``hp``
    (0-d ``clip_range``, ``vf_coef``, ``ent_coef``) -> (grads in ``params``
    order, losses [4]: total, policy, value, entropy, approx_kl [] ), new
    tensors.  Every tensor contiguous float32 (``idx`` int64) on one CUDA
    device.  ``stage`` = (library, call, blocks of fwd, head and back) runs
    the stages elsewhere (the CPU tests' host build).  Raises ValueError for
    what the kernels do not take, RuntimeError when a launch fails."""
    if set(params) != set(KEYS):
        raise ValueError(f"mlp_grad takes an ActorCritic's leaves {KEYS}, got {tuple(params)}")
    obs, act, olp, adv, ret = batch
    D, (H1, H2), A = dims_of(params)
    why = refusal(D, (H1, H2), A)
    if why is not None:
        raise ValueError(f"mlp_grad: {why}")
    M, N = idx.numel(), obs.shape[0]
    dev = params["log_std"].device
    if stage is None and dev.type != "cuda":
        raise ValueError(f"the mlp_grad kernels take CUDA tensors, got {dev}")
    planes = [(k, params[k], torch.float32, params[k].shape) for k in KEYS]
    planes += [("obs", obs, torch.float32, (N, D)), ("action", act, torch.float32, (N, A)),
               ("old_log_prob", olp, torch.float32, (N,)), ("advantages", adv, torch.float32, (N,)),
               ("returns", ret, torch.float32, (N,)), ("idx", idx, torch.int64, (M,))]
    planes += [(n, getattr(hp, n), torch.float32, ()) for n in ("clip_range", "vf_coef", "ent_coef")]
    for name, x, dtype, shape in planes:
        if (x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous()
                or x.device != dev):
            raise ValueError(f"{name}: expected contiguous {dtype} {list(shape)} on {dev}, "
                             f"got {x.dtype} {list(x.shape)} on {x.device}")
    shapes = (M, D, H1, H2, A)
    if stage is None:
        lib, call, index = _card_stage(dev)
        blocks = grids(index)
    else:
        lib, call, blocks = stage
    dims = (_int * 8)(*shapes, *blocks)
    n1, n2, n3 = scratch(lib, dims)
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
    W2 = params["trunk.1.weight"]
    t = dict(obs=obs, act=act, olp=olp, adv=adv, ret=ret, idx=idx,
             log_std=params["log_std"], W1=params["trunk.0.weight"], b1=params["trunk.0.bias"],
             b2=params["trunk.1.bias"], Wm=params["mean.weight"], bm=params["mean.bias"],
             wv=params["value.weight"], bv=params["value.bias"],
             clip=hp.clip_range, vf=hp.vf_coef, ent=hp.ent_coef,
             h1=empty(M, H1), dz2=empty(M, H2), part1=empty(n1, dtype=torch.float64),
             part2=empty(n2), part3=empty(n3), losses=empty(4), kl=empty())
    grads = {k: torch.empty_like(params[k]) for k in GRAD_PTRS}
    t.update({GRAD_PTRS[k]: g for k, g in grads.items()})
    consts = (ctypes.c_float * 3)(*CONSTS)

    def run(name):
        ptrs = (_vp * len(PTRS))(*(t[n].data_ptr() if n in t else None for n in PTRS))
        call(name, dims, ptrs, consts)

    run("fwd")
    t["z2"] = torch.mm(t["h1"], W2.t())
    run("head")
    grads["trunk.1.weight"] = torch.mm(t["dz2"].t(), t["h1"])
    t["dh1"] = torch.mm(t["dz2"], W2)
    run("back")
    run("reduce")
    return [grads[k] for k in params], t["losses"], t["kl"]
