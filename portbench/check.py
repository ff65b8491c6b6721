"""What the loops' checks share (``portbench/loops/<kind>.py``): the
program's state copied into the reference's, the reference env of a
configuration, the gaps the numbers are made of, and :func:`judge`, which
holds each number to its limit in ``portbench/limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from portbench.reference import common as rcm
from portbench.reference import config as rconfig
from portbench.reference import narrowphase as rnph
from portbench.reference import render as rrender
from portbench.reference import types as rtypes

# -- the program's state as the reference's, by field name ---------------------


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def ref_state(s, device, dtype=None) -> rcm.EnvState:
    """A port ``EnvState`` copied into the reference's dataclasses on
    ``device``; ``dtype`` rounds its float tensors through that type."""
    def t(x):
        x = x.detach().to(device)
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype).to(torch.float32)
        return x.clone()

    c = _fields(s)
    bodies = rtypes.Bodies(**{k: t(v) for k, v in _fields(c["bodies"]).items()})
    contacts = _fields(c["contacts"])
    man = rnph.Manifold(**{k: t(v) for k, v in _fields(contacts.pop("man")).items()})
    contacts = rtypes.Contacts(man=man, **{k: t(v) for k, v in contacts.items()})
    rest = {k: t(v) for k, v in c.items() if k not in ("bodies", "contacts")}
    return rcm.EnvState(bodies=bodies, contacts=contacts, **rest)


def cat_states(states) -> object:
    """States concatenated along the env axis (last), field by field."""
    first = states[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: cat_states([getattr(s, f.name) for s in states])
                              for f in dataclasses.fields(first)})
    return torch.cat(list(states), dim=-1)


class RefEnv:
    """The reference env of a configuration: the logic of its variant
    (``portbench/reference/<variant>.py``'s ``Env``, found by name), the
    plain tick and, for an image configuration, the renderer."""

    def __init__(self, config: dict):
        env = config["env"]
        cfg = rconfig.VARIANTS[env["env_id"]]
        img = config.get("image")
        cfg = dataclasses.replace(cfg, velocity_iters=env["velocity_iters"],
                                  position_iters=env["position_iters"],
                                  frameskip=img["frameskip"] if img else cfg.frameskip)
        self.logic = importlib.import_module(f"portbench.reference.{cfg.variant}").Env(cfg)
        self.cfg = cfg
        self.params = self.logic.default_params()
        self.render = (rrender.make_device_renderer(self.logic, downsample=img["downsample"])
                       if img else None)

    @torch.no_grad()
    def step(self, state, action, dtype=None):
        """(state, obs [E, obs_dim], reward, done) of one env step from the
        reference ``state`` with ``action`` [E, act_dim], no autoreset;
        ``dtype`` rounds the action and the outputs through that type."""
        if dtype is not None:
            action = action.to(dtype).to(torch.float32)
        st, obs, rew, done, _info = self.logic.step(state, action.T.contiguous(), self.params)
        if dtype is not None:
            st = _round(st, dtype)
            obs, rew = obs.to(dtype).float(), rew.to(dtype).float()
        return st, obs.T, rew, done


def _round(tree, dtype):
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _round(getattr(tree, f.name), dtype)
                             for f in dataclasses.fields(tree)})
    return tree.to(dtype).float() if tree.is_floating_point() else tree


def max_of(x) -> float:
    """The largest element of ``x``, 0 for none."""
    return float(x.max()) if x.numel() else 0.0


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Per leaf, |‖prog‖ - ‖ref‖| over the larger of the reference leaf's
    norm and the median leaf's norm."""
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = float(np.median(list(rn.values())))
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double())) - rn[k])
            / max(rn[k], med, 1e-30) for k in keys}


def rel_gap(a, b) -> float:
    """The largest |a - b| over the largest |b|."""
    return max_of((a - b).abs()) / max(max_of(b.abs()), 1e-6)


def slice_state(tree, sl):
    """The envs ``sl`` of a state (env axis last)."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: slice_state(getattr(tree, f.name), sl)
                             for f in dataclasses.fields(tree)})
    return tree[..., sl]


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [[name, value, limit]]): every number at or under its limit;
    a number without a limit, or a limit without a number, is not correct."""
    rows, ok = [], True
    for k in sorted({k for k in numbers if not k.startswith("_")} | set(limits)):
        v, lim = numbers.get(k), limits.get(k)
        good = v is not None and lim is not None and np.isfinite(v) and v <= lim
        ok &= bool(good)
        rows.append([k, v, lim])
    return ok, rows
