"""Carry state across between the JAX package and the port.

The JAX package's ``EnvState`` (a tree of flax dataclasses) goes across as
nested dicts of numpy arrays, keyed by field name, with the env batch on the
last axis of every array -- the layout of ``VectorEnv(batch_axis=-1)`` on
both sides.  This module needs neither JAX nor the JAX package: the caller
turns the JAX tree into dicts (its fields are dataclass fields).

The contact solve's inputs go across the same way
(:func:`constraints_from_numpy`, :func:`manifold_from_numpy`), so both
packages' ``solve_contacts`` can be given the same constraints.

JAX PRNG keys are not carried: the port's ``VectorEnv`` owns a
``torch.Generator``.

Policies go across too: :func:`actor_critic_from_numpy` reads the flax
``ActorCritic`` params (``Dense_0 .. Dense_{n+1}`` with ``kernel`` [in, out]
and ``bias``, plus ``log_std``), and :func:`policy_to_npz` /
:func:`policy_from_npz` write and read the slim policy file (params in that
layout, the normalizer moments, ``timesteps``) that ``train/export.py``
writes and ``gym_puzzles_tpu_torch/policies/`` holds.  The pixel policy goes
across as well: :func:`cnn_actor_critic_from_numpy` reads the flax
``CnnActorCritic`` params (``Conv_0 .. Conv_2`` with HWIO kernels,
``Dense_0 .. Dense_2``, ``log_std``), and its policy file records the image
pipeline it was trained on.  :func:`image_state_from_numpy` carries an image
env's state (the env state and its frame stacks).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_puzzles_tpu_torch.api.image_obs import ImageVectorState
from gym_puzzles_tpu_torch.engine.narrowphase import Manifold
from gym_puzzles_tpu_torch.engine.solver import VelocityConstraints
from gym_puzzles_tpu_torch.engine.types import Bodies, Contacts, ShapeTable
from gym_puzzles_tpu_torch.envs.common import EnvState
from gym_puzzles_tpu_torch.train.networks import ActorCritic, CnnActorCritic
from gym_puzzles_tpu_torch.train.normalize import NormalizerState, RunningMeanStd

# dataclass-valued fields of the state tree
_NESTED = {
    (EnvState, "bodies"): Bodies,
    (EnvState, "contacts"): Contacts,
    (Contacts, "man"): Manifold,
}


def from_numpy(cls, tree, device=None):
    """A state dataclass ``cls`` (EnvState, Bodies, Contacts, Manifold) from
    nested dicts of numpy arrays keyed by field name, keeping each dtype."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        sub = _NESTED.get((cls, f.name))
        value = tree[f.name]
        kwargs[f.name] = (from_numpy(sub, value, device) if sub is not None
                          else torch.as_tensor(np.array(value), device=device))
    return cls(**kwargs)


def state_from_numpy(tree, device=None) -> EnvState:
    """The port's EnvState from nested dicts of numpy arrays (bodies,
    contacts with their manifold, flags, distances, goal_pos, t,
    done_status), keeping each array's dtype."""
    return from_numpy(EnvState, tree, device)


def image_state_from_numpy(tree, device=None) -> ImageVectorState:
    """The port's ImageVectorState from ``{"vec": <env state tree>, "frames":
    [E, depth, h, w, 3] uint8}``; ``vec`` may be the JAX ``VectorState``'s
    tree, whose env state sits under ``"env"`` (its PRNG keys are not
    carried)."""
    vec = tree["vec"]
    vec = vec.get("env", vec)
    return ImageVectorState(vec=state_from_numpy(vec, device),
                            frames=torch.as_tensor(np.array(tree["frames"], np.uint8),
                                                   device=device))


def constraints_from_numpy(tree, device=None) -> VelocityConstraints:
    """The port's VelocityConstraints from a dict of numpy arrays keyed by
    field name, env axis last ([P, ..., E])."""
    return from_numpy(VelocityConstraints, tree, device)


def manifold_from_numpy(tree, device=None) -> Manifold:
    """The port's Manifold from a dict of numpy arrays, env axis last."""
    return from_numpy(Manifold, tree, device)


def state_to_numpy(state) -> dict:
    """Inverse of :func:`state_from_numpy`: nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(state):
        return {f.name: state_to_numpy(getattr(state, f.name))
                for f in dataclasses.fields(state)}
    return state.detach().cpu().numpy()


def shape_table_to_numpy(table: ShapeTable) -> dict:
    """Every field of a static table as a numpy array (counts as 0-d)."""
    return {f.name: np.asarray(getattr(table, f.name)) for f in dataclasses.fields(table)}


# --------------------------------------------------------------------------
# policies
# --------------------------------------------------------------------------


def actor_critic_from_numpy(params, device=None) -> ActorCritic:
    """An :class:`ActorCritic` holding the flax params ``{Dense_0, ...,
    Dense_{n+1}, log_std}`` (or the variables dict ``{"params": ...}``):
    ``Dense_0 .. Dense_{n-1}`` the trunk, ``Dense_n`` the mean head,
    ``Dense_{n+1}`` the value head; each ``kernel`` [in, out] becomes
    ``nn.Linear.weight`` [out, in]."""
    params = params.get("params", params)
    n = sum(1 for k in params if k.startswith("Dense_")) - 2
    kernel = lambda i: np.asarray(params[f"Dense_{i}"]["kernel"], np.float32)  # noqa: E731
    hidden = [kernel(i).shape[1] for i in range(n)]
    net = ActorCritic(kernel(0).shape[0], kernel(n).shape[1], hidden)
    layers = list(net.trunk) + [net.mean, net.value]
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    with torch.no_grad():
        for i, layer in enumerate(layers):
            layer.weight.copy_(f32(kernel(i).T))
            layer.bias.copy_(f32(params[f"Dense_{i}"]["bias"]))
        net.log_std.copy_(f32(params["log_std"]))
    return net.to(device)


def cnn_actor_critic_from_numpy(params, obs_shape, device=None) -> CnnActorCritic:
    """A :class:`CnnActorCritic` for uint8 obs of ``obs_shape`` [H, W, C]
    holding the flax params ``{Conv_0..2, Dense_0..2, log_std}`` (or the
    variables dict ``{"params": ...}``): each ``Conv_i.kernel`` [kh, kw, in,
    out] becomes ``Conv2d.weight`` [out, in, kh, kw], each ``Dense_i.kernel``
    [in, out] ``nn.Linear.weight`` [out, in]."""
    params = params.get("params", params)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    kernel = lambda name: np.asarray(params[name]["kernel"], np.float32)  # noqa: E731
    net = CnnActorCritic(obs_shape, kernel("Dense_1").shape[1], kernel("Dense_0").shape[1])
    if tuple(net.dense.weight.shape[::-1]) != kernel("Dense_0").shape:
        raise ValueError(f"Dense_0 {kernel('Dense_0').shape} does not fit obs {obs_shape}")
    with torch.no_grad():
        for i, conv in enumerate(net.convs):
            conv.weight.copy_(f32(kernel(f"Conv_{i}")).permute(3, 2, 0, 1))
            conv.bias.copy_(f32(params[f"Conv_{i}"]["bias"]))
        for i, layer in enumerate((net.dense, net.mean, net.value)):
            layer.weight.copy_(f32(kernel(f"Dense_{i}").T))
            layer.bias.copy_(f32(params[f"Dense_{i}"]["bias"]))
        net.log_std.copy_(f32(params["log_std"]))
    return net.to(device)


def is_cnn(state_dict) -> bool:
    """Whether a state_dict (or a tree keyed as one) is a CnnActorCritic's."""
    return "convs.0.weight" in state_dict


def params_to_numpy(state_dict) -> dict:
    """An :class:`ActorCritic` or :class:`CnnActorCritic` state_dict in the
    flax params layout (inverse of :func:`actor_critic_from_numpy` and
    :func:`cnn_actor_critic_from_numpy`)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    out = {}
    if is_cnn(sd):
        n_conv = sum(1 for k in sd if k.startswith("convs.") and k.endswith(".weight"))
        for i in range(n_conv):
            out[f"Conv_{i}"] = {"kernel": sd[f"convs.{i}.weight"].transpose(2, 3, 1, 0).copy(),
                                "bias": sd[f"convs.{i}.bias"]}
        names = ["dense", "mean", "value"]
    else:
        n = sum(1 for k in sd if k.startswith("trunk.") and k.endswith(".weight"))
        names = [f"trunk.{i}" for i in range(n)] + ["mean", "value"]
    out.update({f"Dense_{i}": {"kernel": sd[f"{name}.weight"].T.copy(),
                               "bias": sd[f"{name}.bias"]}
                for i, name in enumerate(names)})
    out["log_std"] = sd["log_std"]
    return out


def rms_from_numpy(tree, device=None) -> RunningMeanStd:
    """A :class:`RunningMeanStd` from ``{mean, var, count}`` numpy arrays."""
    return RunningMeanStd(**{k: torch.tensor(np.asarray(tree[k], np.float32), device=device)
                             for k in ("mean", "var", "count")})


def normalizer_from_numpy(tree, device=None) -> NormalizerState:
    """The port's :class:`NormalizerState` from the JAX package's, as nested
    dicts of numpy arrays (``obs_rms``, ``ret_rms``, ``returns``, ``gamma``)."""
    return NormalizerState(
        obs_rms=rms_from_numpy(tree["obs_rms"], device),
        ret_rms=rms_from_numpy(tree["ret_rms"], device),
        returns=torch.tensor(np.asarray(tree["returns"], np.float32), device=device),
        gamma=float(np.float32(tree["gamma"])),
    )


# the image pipeline a pixel policy was trained on, as its policy file records it
IMAGE_PIPELINE = ("obs_depth", "frameskip", "downsample", "mode", "block_shape")


@dataclasses.dataclass
class Policy:
    """What evaluation needs of a trained policy: the network, the frozen
    normalizer moments and the env steps it was trained for; for a pixel
    policy also the image pipeline (``IMAGE_PIPELINE`` order) its obs come
    from, else None."""

    net: torch.nn.Module
    obs_rms: RunningMeanStd
    ret_rms: RunningMeanStd
    timesteps: int
    image_pipeline: tuple | None = None


def policy_to_npz(path, params, normalizer, timesteps: int, image_pipeline=None,
                  obs_shape=None):
    """Write the slim policy file: ``params/...`` in the flax layout of
    :func:`params_to_numpy`, ``normalizer/{obs_rms,ret_rms}/{mean,
    var,count}`` and ``timesteps`` (int64), all numpy.  A pixel policy also
    writes ``image/<field>`` for each field of ``image_pipeline``
    (``IMAGE_PIPELINE`` order) and ``image/obs_shape``, so that
    :func:`policy_from_npz` rebuilds its network and its obs pipeline."""
    flat = {"timesteps": np.int64(timesteps)}

    def put(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(f"{prefix}{k}/", v)
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    put("params/", params.get("params", params))
    put("normalizer/", {r: {k: np.asarray(normalizer[r][k], np.float32)
                            for k in ("mean", "var", "count")}
                        for r in ("obs_rms", "ret_rms")})
    if image_pipeline is not None:
        put("image/", dict(zip(IMAGE_PIPELINE, image_pipeline),
                           obs_shape=np.asarray(obs_shape, np.int64)))
    np.savez(path, **flat)


def policy_from_npz(path, device=None) -> Policy:
    """Read a file written by :func:`policy_to_npz`."""
    with np.load(path) as f:
        tree = {}
        for key in f.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[key]
    norm = tree["normalizer"]
    image = tree.get("image")
    if image is None:
        net, pipeline = actor_critic_from_numpy(tree["params"], device), None
    else:
        net = cnn_actor_critic_from_numpy(tree["params"], tuple(image["obs_shape"].tolist()),
                                          device)
        pipeline = tuple(image[k].item() for k in IMAGE_PIPELINE)
    return Policy(net=net,
                  obs_rms=rms_from_numpy(norm["obs_rms"], device),
                  ret_rms=rms_from_numpy(norm["ret_rms"], device),
                  timesteps=int(tree["timesteps"]), image_pipeline=pipeline)
