"""The learner's per-minibatch optimizer step as a hand-written CUDA kernel
pair (``csrc/adam_fused.cu``): its wrapper, grid and binding.

One call clips the gradients to a global norm, takes optax's
``scale_by_adam`` step at ``-lr`` and applies the target-KL freeze, for
every leaf of a parameter dict at once, in two launches: kernel 1 writes one
float64 sum of squares per block and the bias corrections, kernel 2 reduces
the sums in a fixed order in every block and updates the leaves
elementwise, four elements (a quad) a thread at a time.  Its plain version is
``train/ppo.py``'s ``adam_freeze_plain``; ``ppo.adam_freeze_step`` runs
:func:`launch` for CUDA tensors and the plain version for CPU tensors.

* Build, binding and launch count: ``engine/_cuda_build.py`` (a
  :class:`~gym_puzzles_tpu_torch.engine._cuda_build.PlainKernel`: a call adds
  2 launches, and a CUDA graph that captured it adds 2 per replay).
* The leaves keep their own tensors: the dicts in, new tensors out, out of
  place (the inputs are left as they were, as the plain version leaves them).
* The grid follows the element count (:func:`grids`): one algorithm, one
  quad a thread for a small MLP, where the launches and one round of loads
  are the cost, as many blocks as the SMs hold at once for a large CNN,
  where the bytes are.
* The scalars stay on the card: the hyperparameters, Adam's count, the stop
  and the KL are read there, and count', stop' and kl_last' written there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gym_puzzles_tpu_torch.engine import _cuda_build as cb

# csrc/adam_fused.cu's GPT_ADAM_MAX_LEAVES, GPT_ADAM_NORM_THREADS, GPT_ADAM_STEP_THREADS
MAX_LEAVES, NORM_THREADS, STEP_THREADS = 32, 512, 256

_vp, _int = ctypes.c_void_p, ctypes.c_int
# leaves, sizes, pointers, scalars, constants, decays (the host build's whole list)
ARGTYPES = [_int, _vp, _vp, _vp, _vp, _vp]
KERNEL = cb.PlainKernel("adam_fused", "adam_fused.cu", {
    "gpt_adam_fused": (ARGTYPES + [_vp, _int, _int, _vp], _int),
    "gpt_adam_occupancy": ([_vp], _int)})


def quads(sizes) -> int:
    """The quads (4 consecutive elements of one leaf) of leaves of ``sizes``
    elements: the kernels' units of work."""
    return sum(-(-n // 4) for n in sizes)


def grids(n_quads: int, sms: int, per_sm: tuple) -> tuple[int, int]:
    """(kernel 1's blocks, kernel 2's blocks) for ``n_quads`` quads on a card
    of ``sms`` SMs that hold ``per_sm`` blocks of each at once: one quad a
    thread, capped at what the SMs hold (beyond it the threads grid-stride);
    at least one block each."""
    norm = min(-(-n_quads // NORM_THREADS), per_sm[0] * sms)
    step = min(-(-n_quads // STEP_THREADS), per_sm[1] * sms)
    return max(1, norm), max(1, step)


@functools.lru_cache(maxsize=None)
def _occupancy(index: int) -> tuple[int, tuple]:
    """(SMs, blocks of each kernel an SM holds at once) of CUDA device ``index``."""
    per_sm = (_int * 2)()
    with torch.cuda.device(index):
        err = KERNEL.load().gpt_adam_occupancy(per_sm)
    if err != 0:
        raise RuntimeError(f"{KERNEL.name}: the occupancy query failed: CUDA error {err}")
    return torch.cuda.get_device_properties(index).multi_processor_count, tuple(per_sm)


def pack(params: dict, grads: list, mu: dict, nu: dict, scalars: tuple, consts: tuple,
         decays: tuple) -> tuple:
    """The outputs, allocated on the params' device, and the C arguments
    (``ARGTYPES``) that point at inputs and outputs.  ``scalars`` = (lr,
    max_norm, target_kl, count, stop, kl, kl_last), 0-d tensors; ``consts``
    the seven float32 constants, ``decays`` the two float64 decays of
    ``Consts`` in the source.  -> ((params', mu', nu', count', stop',
    kl_last'), args); the args hold raw pointers: keep the tensors alive
    through the call."""
    keys = list(params)
    outs = [{k: torch.empty(params[k].shape, dtype=torch.float32, device=params[k].device)
             for k in keys} for _ in range(3)]
    count, stop, kl_last = scalars[3], scalars[4], scalars[6]
    scalar_outs = (torch.empty_like(count), torch.empty_like(stop), torch.empty_like(kl_last))
    ptrs = [x.data_ptr() for k, g in zip(keys, grads)
            for x in (params[k], g, mu[k], nu[k], outs[0][k], outs[1][k], outs[2][k])]
    args = [len(keys), (ctypes.c_longlong * len(keys))(*(params[k].numel() for k in keys)),
            (_vp * len(ptrs))(*ptrs),
            (_vp * 10)(*(x.data_ptr() for x in scalars + scalar_outs)),
            (ctypes.c_float * 7)(*consts), (ctypes.c_double * 2)(*decays)]
    return (*outs, *scalar_outs), args


def launch(params: dict, grads: list, mu: dict, nu: dict, scalars: tuple, consts: tuple,
           decays: tuple) -> tuple:
    """The kernel pair on CUDA tensors (arguments as :func:`pack`'s) ->
    (params', mu', nu', count', stop', kl_last').  Raises ValueError unless
    every leaf of params, grads, mu and nu is a contiguous float32 tensor of
    its param's shape on one CUDA device, with the scalars 0-d there (count
    int32, stop bool, the rest float32), and RuntimeError when a launch
    fails."""
    keys = list(params)
    if not 0 < len(keys) <= MAX_LEAVES or len(grads) != len(keys):
        raise ValueError(f"adam_fused takes 1 to {MAX_LEAVES} leaves with a gradient each, "
                         f"got {len(keys)} params and {len(grads)} gradients")
    dev = params[keys[0]].device
    planes = [(f"{what}[{k}]", x, torch.float32, params[k].shape)
              for what, xs in (("params", params.values()), ("grads", grads),
                               ("mu", (mu[k] for k in keys)), ("nu", (nu[k] for k in keys)))
              for k, x in zip(keys, xs)]
    dtypes = (torch.float32,) * 3 + (torch.int32, torch.bool) + (torch.float32,) * 2
    names = ("lr", "max_norm", "target_kl", "count", "stop", "kl", "kl_last")
    planes += [(n, x, dt, ()) for n, x, dt in zip(names, scalars, dtypes)]
    cb.check_planes(KERNEL.name, dev, planes)
    outs, args = pack(params, grads, mu, nu, scalars, consts, decays)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    norm_blocks, step_blocks = grids(quads(params[k].numel() for k in keys), *_occupancy(index))
    lib = KERNEL.load()
    with torch.cuda.device(dev):
        # kernel 1's partial sums, then the two bias corrections
        scratch = torch.empty((norm_blocks + 2,), dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gpt_adam_fused(*args, scratch.data_ptr(), norm_blocks, step_blocks, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL.name} kernel launch failed: CUDA error {err}")
    KERNEL.launches += 2
    return outs
