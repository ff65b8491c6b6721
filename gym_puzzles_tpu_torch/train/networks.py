"""Policy/value network (port of ``gym_puzzles_tpu/train/networks.py``).

The reference trains SB3 PPO with ``MlpPolicy`` and ``net_arch=[256, 256]``
(train/configs/ppo-mrp-v3.json:16-18): a shared tanh MLP trunk feeding a
Gaussian policy head with a state-independent log-std and a value head.
Same architecture and initialisation here, in float32.  The pixel policy
(:class:`CnnActorCritic`, SB3's ``CnnPolicy`` NatureCNN trunk) runs its
convolutions in bfloat16, as the JAX package's does.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
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


# NatureCNN: (features, kernel, stride) of each VALID convolution
CNN_LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


def cnn_output_hw(height: int, width: int) -> tuple[int, int]:
    """Spatial size after the NatureCNN convolutions (VALID padding)."""
    for _feat, kern, stride in CNN_LAYERS:
        height, width = (height - kern) // stride + 1, (width - kern) // stride + 1
    return height, width


class CnnActorCritic(nn.Module):
    """SB3 ``CnnPolicy`` equivalent (NatureCNN trunk) for the stacked uint8
    frames of the image pipeline (port of the JAX package's flax
    ``CnnActorCritic``, networks.py:36-62).

    ``forward(obs)`` takes uint8 ``[N, H, W, C]`` frames, scales them to
    [0, 1] in float32, casts to bfloat16 and runs three VALID convolutions
    (32/8/4, 64/4/2, 64/3/1) with ReLU in bfloat16 -- float32 parameters
    cast to bfloat16 for each convolution and its bias, as flax's
    ``dtype=bfloat16, param_dtype=float32``.  The features are flattened in
    NHWC order (``Dense_0``'s rows are indexed ``h*W*C + w*C + c``), cast
    to float32 and go through a 512-wide dense layer with ReLU, a mean head
    and a value head; ``log_std`` is a free parameter.  Orthogonal init with
    gains sqrt(2) (convolutions, dense), 0.01 (mean) and 1 (value), zero
    biases, built on the CPU from ``generator`` when one is given."""

    def __init__(self, obs_shape: Sequence[int], act_dim: int, hidden: int = 512,
                 generator: torch.Generator | None = None):
        super().__init__()
        height, width, channels = (int(x) for x in obs_shape)
        self.obs_shape = (height, width, channels)
        convs = []
        for feat, kern, stride in CNN_LAYERS:
            conv = nn.utils.skip_init(nn.Conv2d, channels, feat, kern, stride=stride)
            with torch.no_grad():
                nn.init.orthogonal_(conv.weight, gain=math.sqrt(2.0), generator=generator)
                conv.bias.zero_()
            convs.append(conv)
            channels = feat
        self.convs = nn.ModuleList(convs)
        oh, ow = cnn_output_hw(height, width)
        if oh < 1 or ow < 1:
            raise ValueError(f"obs {self.obs_shape} is too small for the NatureCNN trunk")
        self.dense = _linear(oh * ow * channels, hidden, math.sqrt(2.0), generator)
        self.mean = _linear(hidden, act_dim, 0.01, generator)
        self.value = _linear(hidden, 1, 1.0, generator)
        self.log_std = nn.Parameter(torch.zeros(act_dim))

    def forward(self, obs):
        x = (obs.to(torch.float32) / 255.0).to(torch.bfloat16).permute(0, 3, 1, 2)
        for conv in self.convs:
            # the convolution's output rounds to bfloat16 before its bias is
            # added, in bfloat16, as XLA computes flax's Conv
            y = F.conv2d(x, conv.weight.to(torch.bfloat16), stride=conv.stride)
            x = torch.relu(y + conv.bias.to(torch.bfloat16)[:, None, None])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(torch.float32)
        x = torch.relu(self.dense(x))
        return self.mean(x), self.log_std, self.value(x)[..., 0]


def gaussian_log_prob(mean, log_std, action):
    """Diagonal Gaussian log-prob, summed over the action dims."""
    var = torch.exp(2.0 * log_std)
    lp = -0.5 * ((action - mean) ** 2 / var + 2.0 * log_std + _LOG_2PI)
    return lp.sum(dim=-1)


def gaussian_entropy(log_std):
    return (log_std + _HALF_LOG_2PIE).sum()
