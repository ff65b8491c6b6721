"""The MLP learner's minibatch gradient as a chain of hand-written CUDA
kernels around the trunk's three GEMMs (``csrc/mlp_grad.cu``, wrapper
``train/mlp_grad.py``) against its plain version, ``PPO.loss`` followed by
``torch.autograd.grad``.

On the CPU:

* (a) The kernel source built as host C++ (g++, no FMA contraction), run
  through the wrapper's own orchestration (``mlp_grad.launch`` with the host
  stages, the GEMMs ``torch.mm`` on the CPU), against ``PPO.loss`` + autograd
  at small minibatches of the v0 (28 observations, 6 actions) and Heavy-v0
  (40 / 15) recipe widths: the ratio clip active and inactive, a minibatch of
  rows that does not fill the last block, the Heavy-v0 X4 hyperparameters,
  and uniform advantages (their std 0, so the 1e-8 guard).  Every gradient
  leaf within ``GRAD_TOL`` of its largest magnitude, the four losses and
  ``approx_kl`` within ``LOSS_TOL`` (relative, at least 1): the kernels sum in
  another order than ATen, with float64 across blocks.
* (b) Who takes the chain (``mlp_grad.takes``), what the wrapper refuses,
  the constants the source and the wrapper share, and ``PPO`` on the CPU
  keeping autograd.

On the card (``cuda``-marked, skipped without one; there: ``python -m pytest
--noconftest -q tests/test_torch_learner_fused.py``, the conftest importing
JAX): the chain against autograd at the v0 and Heavy-v0 recipe shapes (8192
and 16384 rows), determinism over launches, a graph replay against an eager
launch bit for bit, the learner graph's replay against its eager body bit for
bit, the launches per learner replay (4 of ``mlp_grad`` and 2 of
``adam_fused`` per minibatch), the CNN learner launching none of them, and the
wrapper refusing an act_dim it does not take.
"""

import ctypes
import re
import shutil
import subprocess
import types

import pytest
import torch
from torch.func import functional_call

from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train import mlp_grad
from gym_puzzles_tpu_torch.train.networks import ActorCritic, CnnActorCritic, gaussian_log_prob
from gym_puzzles_tpu_torch.train.ppo import PPO, HParams, PPOConfig
from gym_puzzles_tpu_torch.utils import cuda_graph as cg
from gym_puzzles_tpu_torch.utils.profiling import assert_deterministic

torch.set_num_threads(1)

GRAD_TOL = 5e-5  # of each leaf's largest magnitude (the host build reads <= 8.2e-6)
LOSS_TOL = 1e-5  # of max(|value|, 1)
DIMS = {"v0": (28, 6), "heavy-v0": (40, 15)}
# the recipes' hyperparameters: v0 (the PPOConfig defaults) and Heavy-v0 X4
HPARAMS = {"v0": {}, "x4": dict(clip_range=0.1, ent_coef=2e-4, vf_coef=0.5)}


def hparams(device, which="v0"):
    return cg.as_device_scalars(HParams.from_config(PPOConfig(**HPARAMS[which])), device)


def ratios(n: int, clip: str, clip_range: float, generator) -> torch.Tensor:
    """Each row's ratio: inside the clip range ([0.95, 1.05], ``clip``
    'inactive') or across it ([0.5, 1.6]), and never within 1e-3 of a bound
    of ``clip_range``'s, where the kernels' and ATen's round-off could put a
    row on either side."""
    lo, width = (0.95, 0.1) if clip == "inactive" else (0.5, 1.1)
    r = lo + width * torch.rand(n, generator=generator)
    for bound in (1.0 - clip_range, 1.0 + clip_range):
        r = torch.where((r - bound).abs() < 1e-3, r + 2e-3, r)
    return r


def make_case(dims: str, M: int, N: int, clip: str, seed: int = 0, adv: str = "normal",
              hp: str = "v0", device="cpu"):
    """(params, batch, idx) of an ActorCritic at ``dims``' widths: the net's
    init with a log-std and a mean head large enough for real gradients; the
    old log-probs set so that the rows' ratios are :func:`ratios` at the clip
    range of ``HPARAMS[hp]``; advantages normal, or all 0.75 (``adv``
    'uniform': their float32 mean exact, std 0)."""
    D, A = DIMS[dims]
    g = torch.Generator().manual_seed(seed)
    net = ActorCritic(D, A, (256, 256), g)
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    params["log_std"] += 0.3 * torch.randn(A, generator=g)
    params["mean.weight"] *= 30.0
    params["mean.bias"] += 0.1 * torch.randn(A, generator=g)
    obs, act = torch.randn(N, D, generator=g), torch.randn(N, A, generator=g)
    with torch.no_grad():
        mean, log_std, value = functional_call(net, params, (obs,))
        lp = gaussian_log_prob(mean, log_std, act)
    clip_range = HPARAMS[hp].get("clip_range", PPOConfig.clip_range)
    olp = lp - torch.log(ratios(N, clip, clip_range, g))
    advantages = (torch.full((N,), 0.75) if adv == "uniform"
                  else 2.0 * torch.randn(N, generator=g) + 0.3)
    ret = value + torch.randn(N, generator=g)
    idx = torch.randperm(N, generator=g)[:M]
    to = lambda x: x.to(device).contiguous()  # noqa: E731
    return ({k: to(v) for k, v in params.items()}, tuple(map(to, (obs, act, olp, advantages, ret))),
            to(idx))


def autograd(params, batch, idx, hp):
    """``PPO.loss`` + ``torch.autograd.grad`` -> (grads, losses [4], kl)."""
    D, (H1, H2), A = mlp_grad.dims_of(params)
    net = ActorCritic(D, A, (H1, H2)).to(params["log_std"].device)
    algo = types.SimpleNamespace(apply=lambda p, o: functional_call(net, p, (o,)))
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss, (pg, vl, ent, kl) = PPO.loss(algo, p, *(x[idx] for x in batch), hp)
    grads = torch.autograd.grad(loss, list(p.values()))
    return list(grads), torch.stack([loss.detach(), pg, vl, ent]), kl


def assert_matches(got, want):
    (g_grads, g_losses, g_kl), (w_grads, w_losses, w_kl) = got, want
    for k, a, b in zip(mlp_grad.KEYS, g_grads, w_grads):
        assert a.shape == b.shape and a.dtype == torch.float32, k
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= GRAD_TOL * scale, (k, float((a - b).abs().max()),
                                                                scale)
    for a, b in zip(torch.cat([g_losses, g_kl[None]]).tolist(),
                    torch.cat([w_losses, w_kl[None]]).tolist()):
        assert abs(a - b) <= LOSS_TOL * max(abs(b), 1.0), (a, b)


# --------------------------------------------------------------------------
# (a) the kernel source as host C++ against PPO.loss + autograd
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_stage(tmp_path_factory):
    """``csrc/mlp_grad.cu`` built as host C++ with g++: (library, stage call)
    for ``mlp_grad.launch``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source as host C++")
    out = tmp_path_factory.mktemp("mlp_host") / "mlp_grad_host.so"
    subprocess.run([gxx, "-x", "c++", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                    "-o", str(out), str(cb.CSRC / "mlp_grad.cu")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    for stage in mlp_grad.STAGES:
        fn = getattr(lib, f"gpt_mlp_{stage}_host")
        fn.argtypes, fn.restype = mlp_grad._STAGE_ARGS, ctypes.c_int
    lib.gpt_mlp_scratch.argtypes = [ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_longlong)]
    lib.gpt_mlp_scratch.restype = ctypes.c_int
    calls = []

    def call(stage, dims, ptrs, consts):
        calls.append(stage)
        assert getattr(lib, f"gpt_mlp_{stage}_host")(dims, ptrs, consts) == 0

    return lib, call, calls


# blocks of fwd, head and back for the host build: fewer than the tiles of
# rows, so that each block sums over several tiles, as on the card
HOST_GRIDS = (3, 2, 3)


@pytest.mark.parametrize("dims,M,clip,adv,hp", [
    ("v0", 256, "inactive", "normal", "v0"),
    ("v0", 256, "active", "normal", "v0"),
    ("heavy-v0", 256, "inactive", "normal", "x4"),
    ("heavy-v0", 256, "active", "normal", "x4"),
    ("v0", 200, "active", "normal", "v0"),  # the last blocks part full
    ("heavy-v0", 256, "active", "uniform", "x4"),  # std 0: the 1e-8 guard
])
def test_host_chain_against_autograd(host_stage, dims, M, clip, adv, hp):
    lib, call, calls = host_stage
    params, batch, idx = make_case(dims, M, 4 * M, clip, adv=adv, hp=hp)
    h = hparams("cpu", hp)
    del calls[:]
    got = mlp_grad.launch(params, batch, idx, h, stage=(lib, call, HOST_GRIDS))
    assert calls == ["fwd", "head", "back", "reduce"]
    want = autograd(params, batch, idx, h)
    assert_matches(got, want)
    # the case is what it says: the clip binds some rows or none; uniform
    # advantages leave only the value and entropy terms
    D, A = DIMS[dims]
    with torch.no_grad():
        net = ActorCritic(D, A)
        mean, log_std, _v = functional_call(net, params, (batch[0][idx],))
        ratio = torch.exp(gaussian_log_prob(mean, log_std, batch[1][idx]) - batch[2][idx])
    c = float(h.clip_range)
    assert bool(((ratio < 1 - c) | (ratio > 1 + c)).any()) == (clip == "active")
    if adv == "uniform":
        assert float(got[1][1]) == 0.0 and float(got[0][mlp_grad.KEYS.index("mean.bias")]
                                                 .abs().max()) == 0.0


def test_host_chain_reads_the_hyperparameters_at_run_time(host_stage):
    """The same inputs at two clip ranges and entropy coefficients give each
    its own losses and gradients (nothing is baked in)."""
    lib, call, _calls = host_stage
    params, batch, idx = make_case("v0", 128, 512, "active", seed=3)
    runs = [mlp_grad.launch(params, batch, idx, hparams("cpu", hp), stage=(lib, call, HOST_GRIDS))
            for hp in ("v0", "x4")]
    assert float(runs[0][1][1]) != float(runs[1][1][1])  # the policy loss: clip 0.2 / 0.1
    log_std = mlp_grad.KEYS.index("log_std")
    assert not torch.equal(runs[0][0][log_std], runs[1][0][log_std])


def test_host_chain_takes_the_leaves_in_any_order(host_stage):
    """The gradients come back in the order of the params it is given."""
    lib, call, _calls = host_stage
    params, batch, idx = make_case("v0", 64, 256, "active", seed=5)
    h = hparams("cpu")
    shuffled = {k: params[k] for k in reversed(mlp_grad.KEYS)}
    got = mlp_grad.launch(shuffled, batch, idx, h, stage=(lib, call, HOST_GRIDS))
    want = mlp_grad.launch(params, batch, idx, h, stage=(lib, call, HOST_GRIDS))
    assert [tuple(g.shape) for g in got[0]] == [tuple(v.shape) for v in shuffled.values()]
    for g, w in zip(got[0], reversed(want[0])):
        assert torch.equal(g, w)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


# --------------------------------------------------------------------------
# (b) who takes the chain, refusals, shared constants
# --------------------------------------------------------------------------


def test_takes_the_two_layer_mlp_in_its_limits():
    g = torch.Generator().manual_seed(0)
    assert mlp_grad.takes(ActorCritic(28, 6, (256, 256), g))
    assert mlp_grad.takes(ActorCritic(40, 15, (256, 256), g))
    assert mlp_grad.takes(ActorCritic(64, 32, (512, 64), g))
    assert not mlp_grad.takes(ActorCritic(28, 6, (256, 256, 256), g))
    assert not mlp_grad.takes(ActorCritic(28, 6, (256,), g))
    assert not mlp_grad.takes(ActorCritic(65, 6, (256, 256), g))
    assert not mlp_grad.takes(ActorCritic(28, 33, (256, 256), g))
    assert not mlp_grad.takes(ActorCritic(28, 6, (513, 256), g))
    assert not mlp_grad.takes(CnnActorCritic((120, 160, 3), 6, generator=g))


def test_wrapper_refuses_what_the_kernels_do_not_take():
    h = hparams("cpu")
    params, batch, idx = make_case("v0", 64, 128, "active")
    with pytest.raises(ValueError, match="CUDA"):
        mlp_grad.launch(params, batch, idx, h)
    wide = {k: v for k, v in ActorCritic(28, 33).state_dict().items()}
    with pytest.raises(ValueError, match="act_dim 33"):
        mlp_grad.launch(wide, batch, idx, h)
    deep = ActorCritic(28, 6, (64, 64, 64)).state_dict()
    with pytest.raises(ValueError, match="leaves"):
        mlp_grad.launch(deep, batch, idx, h)


def test_cpu_learner_keeps_autograd():
    cfg = PPOConfig(n_envs=2, n_steps=2, batch_size=4, n_epochs=1)
    assert not PPO(cfg, device="cpu").fused_grad


def test_source_and_wrapper_share_their_constants():
    src = (cb.CSRC / "mlp_grad.cu").read_text()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", src).group(1))  # noqa: E731
    assert define("GPT_MLP_MAX_D") == mlp_grad.MAX_OBS
    assert define("GPT_MLP_MAX_A") == mlp_grad.MAX_ACT
    assert define("GPT_MLP_MAX_H") == mlp_grad.MAX_WIDTH
    enum = re.search(r"enum Ptr \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in enum.replace("\n", " ").split(",") if n.strip()]
    assert names[-1] == "P_COUNT"
    assert [n[2:].lower() for n in names[:-1]] == [p.lower() for p in mlp_grad.PTRS]
    assert set(mlp_grad.GRAD_PTRS) | {"trunk.1.weight"} == set(mlp_grad.KEYS)
    assert tuple(ActorCritic(28, 6).state_dict()) == mlp_grad.KEYS
    assert cb.KERNELS["mlp_grad"] is mlp_grad.KERNEL


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py phase 17 runs the learner")
    return torch.device("cuda")


# the recipes' minibatch rows: v0 batch 8192, Heavy-v0 X4 16384
CARD_ROWS = {"v0": 8192, "heavy-v0": 16384}


@pytest.mark.cuda
@pytest.mark.parametrize("clip", ["inactive", "active"])
@pytest.mark.parametrize("dims", ["v0", "heavy-v0"])
def test_chain_against_autograd_on_card(cuda_device, dims, clip):
    M = CARD_ROWS[dims]
    hp = "v0" if dims == "v0" else "x4"
    params, batch, idx = make_case(dims, M, 2 * M, clip, seed=1, hp=hp, device=cuda_device)
    h = hparams(cuda_device, hp)
    before = cb.launch_count("mlp_grad")
    got = mlp_grad.launch(params, batch, idx, h)
    torch.cuda.synchronize()
    assert cb.launch_count("mlp_grad") == before + 4
    assert_matches(got, autograd(params, batch, idx, h))


@pytest.mark.cuda
def test_chain_is_deterministic_on_card(cuda_device):
    params, batch, idx = make_case("heavy-v0", 16384, 32768, "active", seed=2, hp="x4",
                                   device=cuda_device)
    h = hparams(cuda_device, "x4")
    assert_deterministic(lambda: mlp_grad.launch(params, batch, idx, h), n=3)


@pytest.mark.cuda
def test_graph_replay_equals_eager_launch_on_card(cuda_device):
    params, batch, idx = make_case("v0", 8192, 16384, "active", seed=4, device=cuda_device)
    h = hparams(cuda_device)
    eager = mlp_grad.launch(params, batch, idx, h)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as torch's capture wants
        mlp_grad.launch(params, batch, idx, h)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        grads, losses, kl = mlp_grad.launch(params, batch, idx, h)
    captured = grads + [losses, kl]
    for x in captured:
        x.fill_(0)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager[0] + [eager[1], eager[2]]):
        assert torch.equal(a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32))


def small_config(**kw) -> PPOConfig:
    return PPOConfig(**dict(dict(n_envs=256, n_steps=8, batch_size=512, n_epochs=2,
                                 velocity_iters=8, position_iters=4), **kw))


@pytest.mark.cuda
def test_learner_graph_replay_equals_eager_on_card(cuda_device):
    """Two chained updates through both graphs against the eager bodies from
    the same state and generator states: every element of the state and the
    metrics bit for bit."""
    algo = PPO(small_config(), device=cuda_device)
    assert algo.fused_grad
    ts = algo.init_state()
    states = ts.generator.get_state(), algo.env.generator.get_state()
    got, gts = [], ts
    for _ in range(2):
        gts, metrics = algo.train_step(gts)
        got.append((ckpt.to_tree(gts), metrics))
    ts.generator.set_state(states[0])
    algo.env.generator.set_state(states[1])
    ets = ts
    for g_state, g_metrics in got:
        ets, metrics = algo.train_step_eager(ets)
        a, spec_a = cg.flatten((g_state, g_metrics))
        b, spec_b = cg.flatten((ckpt.to_tree(ets), metrics))
        assert spec_a == spec_b
        for x, y in zip(a, b):
            assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
def test_launches_per_learner_replay_on_card(cuda_device):
    cfg = small_config(target_kl=5e-4)
    algo = PPO(cfg, device=cuda_device)
    ts = algo.init_state()
    ts, _m = algo.train_step(ts)
    minibatches = cfg.n_epochs * (cfg.n_envs * cfg.n_steps // cfg.batch_size)
    assert algo.graph_launches["learner"] == {"adam_fused": 2 * minibatches,
                                              "mlp_grad": 4 * minibatches}
    before = cb.launch_count("mlp_grad")
    ts, _m = algo.train_step(ts)
    assert cb.launch_count("mlp_grad") - before == 4 * minibatches


@pytest.mark.cuda
def test_cnn_learner_launches_none_on_card(cuda_device):
    cfg = PPOConfig(policy="cnn", n_envs=8, n_steps=4, batch_size=16, n_epochs=1,
                    velocity_iters=8, position_iters=4)
    algo = PPO(cfg, device=cuda_device)
    assert not algo.fused_grad
    ts = algo.init_state()
    ts, _m = algo.train_step(ts)
    assert "mlp_grad" not in algo.graph_launches["learner"]
    assert algo.graph_launches["learner"] == {"adam_fused": 2 * cfg.n_epochs * 2}


@pytest.mark.cuda
def test_wrapper_refuses_an_act_dim_it_does_not_take_on_card(cuda_device):
    params, batch, idx = make_case("v0", 256, 512, "active", device=cuda_device)
    wide = {k: v.to(cuda_device) for k, v in ActorCritic(28, 33).state_dict().items()}
    before = cb.launch_count("mlp_grad")
    with pytest.raises(ValueError, match="act_dim 33"):
        mlp_grad.launch(wide, batch, idx, hparams(cuda_device))
    assert cb.launch_count("mlp_grad") == before
    mlp_grad.launch(params, batch, idx, hparams(cuda_device))  # and the right form launches
    torch.cuda.synchronize()
