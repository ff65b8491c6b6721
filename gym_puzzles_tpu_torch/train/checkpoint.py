"""Checkpoint and resume (port of ``gym_puzzles_tpu/train/checkpoint.py``).

The reference checkpoints the SB3 model zip and the VecNormalize statistics
(train/train.py:148-149).  Here the whole :class:`TrainState` -- params,
Adam state, normalizer, env batch, both generators' states, episode
statistics, env params and hparams -- is one file, ``<dir>/<step>/state.pt``
written by ``torch.save`` as nested dicts of tensors and numbers, so a
restore continues the exact trajectory.

A distributed learner (``parallel/mesh.py``) passes its ``mesh``: rank 0
writes the replicated part once (``state.pt``, with the world size) and
every rank its shard (``shard_<rank>.pt``: its envs, obs, episode counters,
normalizer returns and both generators, as ``train_state_specs`` names
them), into one directory that the ranks share.  A fresh job of the same
world size restores them and continues bit for bit.
"""

from __future__ import annotations

import dataclasses
import pathlib

import torch

from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.parallel.mesh import train_state_specs

STATE_FILE = "state.pt"


def step_count(timesteps) -> int:
    """The env steps of a TrainState's counter as a Python int.  The counter
    is int64, so it stays exact and positive past 2^31 (the JAX package's
    int32 counter wraps there)."""
    return int(timesteps)


def to_tree(x):
    """Dataclasses and generators -> dicts, generator states and tensors."""
    if dataclasses.is_dataclass(x):
        return {f.name: to_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: to_tree(v) for k, v in x.items()}
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return x


def from_tree(template, tree):
    """Inverse of :func:`to_tree` onto ``template``'s classes and devices;
    a generator of the template is set to the saved state in place."""
    if dataclasses.is_dataclass(template):
        return type(template)(**{f.name: from_tree(getattr(template, f.name), tree[f.name])
                                 for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        if set(template) != set(tree):
            raise ValueError(f"checkpoint keys {sorted(tree)} do not match {sorted(template)}")
        return {k: from_tree(template[k], tree[k]) for k in template}
    if isinstance(template, torch.Generator):
        template.set_state(tree)
        return template
    if isinstance(template, torch.Tensor):
        if tree.shape != template.shape or tree.dtype != template.dtype:
            raise ValueError(f"checkpoint tensor {tuple(tree.shape)} {tree.dtype} does not "
                             f"match {tuple(template.shape)} {template.dtype}")
        return tree.to(template.device)
    return tree


def _step_dir(path, step: int | None) -> pathlib.Path:
    path = pathlib.Path(path).absolute()
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    return path / str(step)


def load(path, step: int | None = None) -> dict:
    """The saved tree (nested dicts of CPU tensors and numbers) at ``step``
    (default: the latest); of a distributed learner's checkpoint, the
    replicated part and ``world_size``."""
    tree = torch.load(_step_dir(path, step) / STATE_FILE, map_location="cpu",
                      weights_only=True)
    tree.setdefault("image_pipeline", None)  # flat-obs checkpoints written before it existed
    return tree


def _split(tree: dict, paths) -> tuple:
    """(``tree`` without the dotted ``paths``, their subtrees)."""
    rest, part = dict(tree), {}
    for p in paths:
        *parents, leaf = p.split(".")
        src, dst = rest, part
        for k in parents:
            src[k] = dict(src[k])
            src, dst = src[k], dst.setdefault(k, {})
        dst[leaf] = src.pop(leaf)
    return rest, part


def _merge(a: dict, b: dict) -> dict:
    """Inverse of :func:`_split`."""
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a[k], v) if k in a else v
    return out


def check_pipeline(saved, template):
    """Raise unless the image pipeline a checkpoint or policy file records
    is the ``template``'s (both None for a flat-obs learner)."""
    saved = None if saved is None else tuple(saved)
    if saved != template.image_pipeline:
        raise ValueError(f"the checkpoint's image pipeline {saved} does not match the "
                         f"learner's {template.image_pipeline}")


def save(path, train_state, step: int, mesh=None):
    """Write ``train_state`` to ``<path>/<step>/state.pt``; with a ``mesh``
    (every rank calls this) the replicated part there and this rank's shard
    to ``shard_<rank>.pt``.  ``state.pt`` is written last, so
    :func:`latest_step` finds only complete checkpoints."""
    out = pathlib.Path(path).absolute() / str(int(step))
    out.mkdir(parents=True, exist_ok=True)
    tree = to_tree(train_state)
    if mesh is None:
        torch.save(tree, out / STATE_FILE)
        return
    specs = train_state_specs(train_state)
    replicated, shard = _split(tree, [k for k, sharded in specs.items() if sharded])
    torch.save(shard, out / f"shard_{mesh.rank}.pt")
    mesh.barrier()
    if mesh.rank == 0:
        torch.save(dict(replicated, world_size=mesh.world_size), out / STATE_FILE)
    mesh.barrier()


def restore(path, template, step: int | None = None, mesh=None):
    """The TrainState saved at ``step`` (default: the latest), onto a
    ``template`` of the same shapes (e.g. ``PPO.init_state()``).  The
    template's generators -- the env's among them -- take the saved states.
    A distributed learner's checkpoint restores only with a ``mesh`` of its
    world size, each rank taking its own shard."""
    step_dir = _step_dir(path, step)
    tree = load(step_dir.parent, int(step_dir.name))
    check_pipeline(tree["image_pipeline"], template)
    world, want = tree.pop("world_size", None), None if mesh is None else mesh.world_size
    if world != want:
        raise ValueError(f"checkpoint of world size {world} restored at world size {want} "
                         "(None: a single-process learner's)")
    if mesh is not None:
        tree = _merge(tree, torch.load(step_dir / f"shard_{mesh.rank}.pt", map_location="cpu",
                                       weights_only=True))
    return from_tree(template, tree)


def restore_policy(path, template, step: int | None = None):
    """Only the policy: params, the obs/ret normalizer moments and
    ``timesteps``, grafted into a ``template`` built at any env batch size
    (the analogue of the reference's PPO.load + VecNormalize.load with
    training=False, test.py:66-74).  ``path`` is a checkpoint directory or
    a policy ``.npz`` (``train/export.py``); its image pipeline must be the
    template's."""
    dev = template.timesteps.device
    if str(path).endswith(".npz"):
        pol = convert.policy_from_npz(path)
        tree = {"params": pol.net.state_dict(), "timesteps": pol.timesteps,
                "normalizer": {"obs_rms": to_tree(pol.obs_rms),
                               "ret_rms": to_tree(pol.ret_rms)},
                "image_pipeline": pol.image_pipeline}
    else:
        tree = load(path, step)
    check_pipeline(tree["image_pipeline"], template)
    norm = template.normalizer
    return template.replace(
        params=from_tree(template.params, tree["params"]),
        normalizer=norm.replace(obs_rms=from_tree(norm.obs_rms, tree["normalizer"]["obs_rms"]),
                                ret_rms=from_tree(norm.ret_rms, tree["normalizer"]["ret_rms"])),
        timesteps=torch.tensor(int(tree["timesteps"]), dtype=torch.int64, device=dev),
    )


def latest_step(path) -> int | None:
    """The largest step saved under ``path``, or None."""
    path = pathlib.Path(path).absolute()
    if not path.is_dir():
        return None
    steps = [int(d.name) for d in path.iterdir()
             if d.name.isdigit() and (d / STATE_FILE).is_file()]
    return max(steps, default=None)
