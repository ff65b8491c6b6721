"""Policy/value network (port of ``gym_puzzles_tpu/train/networks.py``).

The reference trains SB3 PPO with ``MlpPolicy`` and ``net_arch=[256, 256]``
(train/configs/ppo-mrp-v3.json:16-18): a shared tanh MLP trunk feeding a
Gaussian policy head with a state-independent log-std and a value head.
Same architecture and initialisation here, in float32.  The pixel policy
(``CnnActorCritic``) comes with the pixel pipeline.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

# float32 constants as the JAX package computes them (jnp.log of a Python
# float rounds the argument to float32 first)
_LOG_2PI = float(np.log(np.float32(2.0 * math.pi)))
_HALF_LOG_2PIE = float(np.float32(0.5) * np.log(np.float32(2.0 * math.pi * math.e)))


def _linear(n_in: int, n_out: int, gain: float, generator: torch.Generator | None):
    """``nn.Linear`` with an orthogonal weight of ``gain`` and a zero bias,
    drawn from ``generator`` (the module's default init, which would draw
    from the global generator, is skipped)."""
    layer = nn.utils.skip_init(nn.Linear, n_in, n_out)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
        layer.bias.zero_()
    return layer


class ActorCritic(nn.Module):
    """Tanh MLP trunk, a mean head and a value head; ``log_std`` is a free
    parameter.  ``forward(obs)`` returns ``(mean, log_std, value)`` with
    ``value`` of shape ``obs.shape[:-1]``.  Orthogonal init with gains
    sqrt(2) (trunk), 0.01 (mean) and 1 (value), zero biases, as the JAX
    package's flax module (networks.py:26-32); built on the CPU, from
    ``generator`` when one is given."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: Sequence[int] = (256, 256),
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [int(obs_dim)] + [int(w) for w in hidden]
        self.trunk = nn.ModuleList(
            _linear(a, b, math.sqrt(2.0), generator) for a, b in zip(widths[:-1], widths[1:]))
        self.mean = _linear(widths[-1], act_dim, 0.01, generator)
        self.value = _linear(widths[-1], 1, 1.0, generator)
        self.log_std = nn.Parameter(torch.zeros(act_dim))

    def forward(self, obs):
        x = obs
        for layer in self.trunk:
            x = torch.tanh(layer(x))
        return self.mean(x), self.log_std, self.value(x)[..., 0]


def gaussian_log_prob(mean, log_std, action):
    """Diagonal Gaussian log-prob, summed over the action dims."""
    var = torch.exp(2.0 * log_std)
    lp = -0.5 * ((action - mean) ** 2 / var + 2.0 * log_std + _LOG_2PI)
    return lp.sum(dim=-1)


def gaussian_entropy(log_std):
    return (log_std + _HALF_LOG_2PIE).sum()
