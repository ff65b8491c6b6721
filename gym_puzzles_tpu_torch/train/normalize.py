"""VecNormalize-equivalent running normalization (port of
``gym_puzzles_tpu/train/normalize.py``).

The reference wraps its envs in SB3 ``VecNormalize`` (train/train.py:82):
observations are standardized by running mean/var (clip 10) and rewards are
scaled by the running std of the *discounted return* (clip 10).  Its
statistics are part of the checkpoint (train.py:149; test.py:66-68 reloads
them with training=False).  Here they are tensors on the device, and every
function returns a new state instead of updating one.
"""

from __future__ import annotations

import dataclasses

import torch

from gym_puzzles_tpu_torch.engine.types import Replaceable

CLIP_OBS = 10.0
CLIP_REWARD = 10.0
EPS = 1e-8


@dataclasses.dataclass
class RunningMeanStd(Replaceable):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # [] float32

    @staticmethod
    def create(shape, device=None) -> "RunningMeanStd":
        return RunningMeanStd(
            mean=torch.zeros(shape, dtype=torch.float32, device=device),
            var=torch.ones(shape, dtype=torch.float32, device=device),
            count=torch.tensor(1e-4, dtype=torch.float32, device=device),
        )

    def update(self, batch) -> "RunningMeanStd":
        """Parallel Welford update over the leading batch axis, with the
        batch's population variance."""
        b_mean = batch.mean(dim=0)
        b_var = batch.var(dim=0, correction=0)
        b_count = float(batch.shape[0])  # exact in float32, as JAX's count
        delta = b_mean - self.mean
        tot = self.count + b_count
        mean = self.mean + delta * b_count / tot
        m_a = self.var * self.count
        m_b = b_var * b_count
        m2 = m_a + m_b + delta**2 * self.count * b_count / tot
        return RunningMeanStd(mean=mean, var=m2 / tot, count=tot)


@dataclasses.dataclass
class NormalizerState(Replaceable):
    obs_rms: RunningMeanStd
    ret_rms: RunningMeanStd
    returns: torch.Tensor  # [E] running discounted returns
    gamma: float  # a Python float holding a float32 value

    @staticmethod
    def create(obs_dim, num_envs, gamma=0.99, device=None) -> "NormalizerState":
        return NormalizerState(
            obs_rms=RunningMeanStd.create((obs_dim,), device),
            ret_rms=RunningMeanStd.create((), device),
            returns=torch.zeros((num_envs,), dtype=torch.float32, device=device),
            gamma=gamma,
        )


def normalize_obs(state: NormalizerState, obs, update: bool = True):
    """-> (state', normalized obs).  ``update=False`` for evaluation
    (VecNormalize training=False, test.py:66-68)."""
    if update:
        state = state.replace(obs_rms=state.obs_rms.update(obs))
    n = (obs - state.obs_rms.mean) / torch.sqrt(state.obs_rms.var + EPS)
    return state, torch.clamp(n, -CLIP_OBS, CLIP_OBS)


def normalize_reward(state: NormalizerState, reward, done, update: bool = True):
    """-> (state', normalized reward).  Scales by the running std of the
    discounted return; the return is updated before the statistics (SB3's
    order) and reset where an episode is done."""
    returns = state.returns * state.gamma + reward
    if update:
        state = state.replace(ret_rms=state.ret_rms.update(returns),
                              returns=torch.where(done, 0.0, returns))
    n = reward / torch.sqrt(state.ret_rms.var + EPS)
    return state, torch.clamp(n, -CLIP_REWARD, CLIP_REWARD)
