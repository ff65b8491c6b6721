"""The learner's per-minibatch optimizer step (``train/ppo.py::adam_freeze_step``):
the fused kernel pair (``csrc/adam_fused.cu``, wrapper ``train/adam_fused.py``)
and its plain version (``adam_freeze_plain``).

On the CPU:

* (a) ``adam_freeze_step`` on CPU tensors equals, bit for bit, the composition
  the learner ran before the kernel (``adam_step``, then ``torch.where`` over
  params, Adam's moments and count, with its stop and ``kl_last`` updates),
  over a sequence of minibatches at v0's leaf shapes, the clip active and
  inactive, with a KL stop that fires mid-sequence so that the later
  minibatches are frozen.
* (b) The kernel source built as host C++ (g++, no FMA contraction): with
  the clip inactive bit for bit against float32 arithmetic rounded once at
  each operation in ``adam_update``'s order, at Adam counts up to 10^5 (the
  bias corrections' float64 power); within 1e-6 of each leaf's largest
  magnitude against the plain version, the clip active (the norm's sum runs
  in another order) or not; a frozen step returns every input bit.
* (c) The grid follows the element count; (d) the constants the source and
  the wrapper share agree; (e) the wrapper takes no CPU tensor.

On the card (``cuda``-marked, skipped without one; there: ``python -m pytest
--noconftest -q tests/test_torch_adam_fused.py``, the conftest importing
JAX; ``chip_smoke.py`` phase 17 runs the comparison and times it): the
kernel against the plain version on the card at v0's and the pixel CNN's leaf
shapes (the CNN's convolution gradients channels-last, as autograd gives
them), a frozen step, determinism, a graph replay against an eager launch,
the launches per learner replay, and the inputs it refuses.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.train import adam_fused
from gym_puzzles_tpu_torch.train import ppo as tppo
from gym_puzzles_tpu_torch.train.networks import ActorCritic, CnnActorCritic
from gym_puzzles_tpu_torch.train.ppo import PPO, AdamState, HParams, PPOConfig
from gym_puzzles_tpu_torch.utils import cuda_graph as cg
from gym_puzzles_tpu_torch.utils.profiling import assert_deterministic

torch.set_num_threads(1)

# v0's flat learner: 28 observations, 6 actions, 256 x 256 (75,021 parameters)
V0_SHAPES = {k: tuple(v.shape) for k, v in
             ActorCritic(28, 6, (256, 256), torch.Generator().manual_seed(0)).state_dict().items()}
# the max_grad_norm of the recipes; gradients of this scale keep their norm
# under it (clip inactive) or far above it (clip active)
MAX_GRAD_NORM = 0.5
SCALES = {"inactive": 1e-4, "active": 1.0}


def hparams(device, target_kl=0.01):
    hp = HParams.from_config(PPOConfig(max_grad_norm=MAX_GRAD_NORM, target_kl=target_kl))
    return cg.as_device_scalars(hp, device)


def draw(shapes: dict, seed: int, scale: float, count: int = 3, device="cpu"):
    """(params, grads, opt) drawn from ``seed``: params and grads normal
    (grads times ``scale``), Adam's moments of a few steps' size."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda s, a: (torch.randn(s, generator=gen) * a).to(device)  # noqa: E731
    params = {k: r(s, 1.0) for k, s in shapes.items()}
    grads = [r(s, scale) for s in shapes.values()]
    opt = AdamState(mu={k: r(s, 0.1 * scale) for k, s in shapes.items()},
                    nu={k: r(s, 0.1 * scale) ** 2 for k, s in shapes.items()},
                    count=torch.tensor(count, dtype=torch.int32, device=device))
    return params, grads, opt


def scalars(device, stop=False, kl=0.0, kl_last=0.0):
    return (torch.tensor(stop, device=device), torch.tensor(kl, device=device),
            torch.tensor(kl_last, device=device))


def old_composition(params, grads, opt, stop, kl, kl_last, hp):
    """The learner's optimizer step as ``PPO.minibatch_steps`` wrote it before
    the kernel."""
    kl_limit, kl_on = 1.5 * hp.target_kl, hp.target_kl > 0.0
    new_params, new_opt = tppo.adam_step(params, grads, opt, hp)
    use = ~stop
    keep = lambda new, old: {k: torch.where(use, new[k], old[k]) for k in old}  # noqa: E731
    params = keep(new_params, params)
    opt = AdamState(mu=keep(new_opt.mu, opt.mu), nu=keep(new_opt.nu, opt.nu),
                    count=torch.where(use, new_opt.count, opt.count))
    stop = stop | (use & kl_on & (kl > kl_limit))
    kl_last = torch.where(use, kl, kl_last)
    return params, opt, stop, kl_last


def leaves(out) -> list:
    params, opt, stop, kl_last = out
    return ([params[k] for k in params] + [opt.mu[k] for k in opt.mu]
            + [opt.nu[k] for k in opt.nu] + [opt.count, stop, kl_last])


def assert_bitwise(a: list, b: list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype != torch.bool:
            x, y = x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)
        assert torch.equal(x, y)


def assert_close_to_leaf_scale(a: list, b: list, rel=1e-6):
    """Every element within ``rel`` of its leaf's largest magnitude; the
    integer and bool scalars equal."""
    for x, y in zip(a, b):
        if x.dtype in (torch.int32, torch.bool):
            assert torch.equal(x, y)
            continue
        scale = float(y.abs().max())
        assert float((x - y).abs().max()) <= rel * scale, (float((x - y).abs().max()), scale)


# --------------------------------------------------------------------------
# (a) the step on CPU tensors is the old composition, bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("clip", ["inactive", "active"])
def test_cpu_step_equals_the_old_composition(clip):
    hp = hparams("cpu")
    kls = [0.001, 0.012, 0.02, 0.001, 0.03, 0.002]  # 0.02 > 1.5 x 0.01: the stop fires at 2
    params, _g, opt = draw(V0_SHAPES, 0, SCALES[clip])
    new = old = (params, opt, *scalars("cpu")[::2])
    frozen_from = None
    for i, kl in enumerate(kls):
        grads = draw(V0_SHAPES, 10 + i, SCALES[clip])[1]
        kl = torch.tensor(kl)
        new = tppo.adam_freeze_step(new[0], grads, new[1], new[2], kl, new[3], hp)
        old = old_composition(old[0], grads, old[1], old[2], kl, old[3], hp)
        assert_bitwise(leaves(new), leaves(old))
        if frozen_from is None and bool(new[2]):
            frozen_from = i + 1
    assert frozen_from == 3
    assert int(new[1].count) == 3 + 3 and float(new[3]) == np.float32(0.02)
    # the clip was what the case says: inactive leaves the gradients' norm as it is
    g_norm = torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in grads]))
    assert (float(g_norm) < MAX_GRAD_NORM) == (clip == "inactive")


def test_cpu_step_without_stop_applies_every_minibatch():
    hp = hparams("cpu", target_kl=0.0)  # target_kl <= 0: no stop
    params, grads, opt = draw(V0_SHAPES, 1, SCALES["active"])
    stop, kl, kl_last = scalars("cpu", kl=5.0)
    p, o, s, k = tppo.adam_freeze_step(params, grads, opt, stop, kl, kl_last, hp)
    assert not bool(s) and int(o.count) == 4 and float(k) == 5.0
    assert all(not torch.equal(p[n], params[n]) for n in params)


# --------------------------------------------------------------------------
# (b) the kernel source as host C++ against the plain version
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``csrc/adam_fused.cu`` built as host C++ with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source as host C++")
    out = tmp_path_factory.mktemp("adam_host") / "adam_fused_host.so"
    subprocess.run([gxx, "-x", "c++", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                    "-o", str(out), str(cb.CSRC / "adam_fused.cu")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    lib.gpt_adam_fused_host.argtypes = adam_fused.ARGTYPES
    lib.gpt_adam_fused_host.restype = ctypes.c_int
    return lib


def host_step(lib, params, grads, opt, stop, kl, kl_last, hp):
    sc = (hp.learning_rate, hp.max_grad_norm, hp.target_kl, opt.count, stop, kl, kl_last)
    (p, mu, nu, count, stop, kl_last), args = adam_fused.pack(
        params, grads, opt.mu, opt.nu, sc, tppo._KERNEL_CONSTS, tppo._ADAM_DECAYS)
    assert lib.gpt_adam_fused_host(*args) == 0
    return p, AdamState(mu=mu, nu=nu, count=count), stop, kl_last


def ieee_step(params, grads, opt, hp) -> tuple:
    """``adam_update``'s operations with the clip inactive (so 1), in numpy
    float32, each rounded once to nearest, the bias corrections
    ``bias_corrections``': (params', mu', nu')."""
    c1, b1, c2, b2, eps = (np.float32(x) for x in tppo._KERNEL_CONSTS[:5])
    bc1, bc2 = (x.numpy() for x in tppo.bias_corrections(opt.count + 1))
    neg_lr = -hp.learning_rate.numpy()
    out = ({}, {}, {})
    for (k, p), g in zip(params.items(), grads):
        g, m, v = g.numpy(), opt.mu[k].numpy(), opt.nu[k].numpy()
        m1 = g * c1 + m * b1
        v1 = (g * g) * c2 + v * b2
        step = (m1 / bc1) / (np.sqrt(v1 / bc2) + eps)
        for d, x in zip(out, (p.numpy() + step * neg_lr, m1, v1)):
            d[k] = torch.from_numpy(x)
    return out


@pytest.mark.parametrize("count", [0, 1, 9, 999, 99_999])
@pytest.mark.parametrize("clip", ["inactive", "active"])
def test_host_kernel_against_plain(host_lib, clip, count):
    """Bit for bit against float32 arithmetic rounded at each operation (the
    clip inactive); within 1e-6 of each leaf's largest magnitude against the
    plain version on the CPU, whose vectorized square root is not always the
    correctly rounded one (1 ulp off on a few elements in 10^5); on the card
    the plain version's is, and the card test holds the two bit for bit."""
    hp = hparams("cpu")
    params, grads, opt = draw(V0_SHAPES, 2, SCALES[clip], count=count)
    stop, kl, kl_last = scalars("cpu", kl=0.02, kl_last=0.003)
    got = host_step(host_lib, params, grads, opt, stop, kl, kl_last, hp)
    want = tppo.adam_freeze_plain(params, grads, opt, stop, kl, kl_last, hp)
    assert_close_to_leaf_scale(leaves(got), leaves(want))
    if clip == "inactive":
        ieee = ieee_step(params, grads, opt, hp)
        assert_bitwise([x for d in got[:1] + (got[1].mu, got[1].nu) for x in d.values()],
                       [x for d in ieee for x in d.values()])
    assert bool(got[2]) and int(got[1].count) == count + 1 and float(got[3]) == np.float32(0.02)


def test_host_kernel_frozen_step_returns_its_inputs(host_lib):
    hp = hparams("cpu")
    params, grads, opt = draw(V0_SHAPES, 3, SCALES["active"])
    stop, kl, kl_last = scalars("cpu", stop=True, kl=0.5, kl_last=0.003)
    got = host_step(host_lib, params, grads, opt, stop, kl, kl_last, hp)
    assert_bitwise(leaves(got), leaves((params, opt, stop, kl_last)))
    assert_bitwise(leaves(got), leaves(tppo.adam_freeze_plain(params, grads, opt, stop, kl,
                                                              kl_last, hp)))


# --------------------------------------------------------------------------
# (c)-(e) grid, shared constants, refusals
# --------------------------------------------------------------------------


def test_grid_follows_the_element_count():
    sms, per_sm = 132, (4, 6)
    v0 = adam_fused.quads(int(np.prod(s)) for s in V0_SHAPES.values())
    cnn = adam_fused.quads([21_575_853])  # the pixel recipe's NatureCNN at 6 actions
    assert adam_fused.quads([1, 4, 5, 0]) == 1 + 1 + 2
    small, large = adam_fused.grids(v0, sms, per_sm), adam_fused.grids(cnn, sms, per_sm)
    # one quad a thread for the MLP, where the launches are the cost
    assert small == (-(-v0 // adam_fused.NORM_THREADS), -(-v0 // adam_fused.STEP_THREADS))
    assert small[0] < sms and small[1] < per_sm[1] * sms
    # as many blocks as the SMs hold for the CNN
    assert large == (per_sm[0] * sms, per_sm[1] * sms)
    assert adam_fused.grids(1, sms, per_sm) == (1, 1) and adam_fused.grids(0, sms, per_sm) == (1, 1)
    sizes = [1, 1000, v0, 10**6, cnn]
    for a, b in zip(sizes, sizes[1:]):
        assert all(x <= y for x, y in zip(adam_fused.grids(a, sms, per_sm),
                                          adam_fused.grids(b, sms, per_sm)))


def test_source_and_wrapper_share_their_constants():
    src = (cb.CSRC / "adam_fused.cu").read_text()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", src).group(1))  # noqa: E731
    assert define("GPT_ADAM_MAX_LEAVES") == adam_fused.MAX_LEAVES
    assert define("GPT_ADAM_NORM_THREADS") == adam_fused.NORM_THREADS
    assert define("GPT_ADAM_STEP_THREADS") == adam_fused.STEP_THREADS
    assert len(tppo._KERNEL_CONSTS) == 7 and len(tppo._ADAM_DECAYS) == 2
    assert tppo._KERNEL_CONSTS == tuple(float(np.float32(x)) for x in (
        1 - tppo.ADAM_B1, tppo.ADAM_B1, 1 - tppo.ADAM_B2, tppo.ADAM_B2, tppo.ADAM_EPS,
        tppo.CLIP_EPS, tppo.KL_FACTOR))
    assert cb.KERNELS["adam_fused"] is adam_fused.KERNEL


def test_wrapper_takes_no_cpu_tensor():
    hp = hparams("cpu")
    params, grads, opt = draw(V0_SHAPES, 4, 1.0)
    stop, kl, kl_last = scalars("cpu")
    sc = (hp.learning_rate, hp.max_grad_norm, hp.target_kl, opt.count, stop, kl, kl_last)
    before = cb.launch_count("adam_fused")
    with pytest.raises(ValueError, match="CUDA"):
        adam_fused.launch(params, grads, opt.mu, opt.nu, sc, tppo._KERNEL_CONSTS,
                          tppo._ADAM_DECAYS)
    assert cb.launch_count("adam_fused") == before


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py phase 17 runs this check")
    return torch.device("cuda")


_CNN_SHAPES = []


def cnn_shapes() -> dict:
    """The pixel recipe's NatureCNN leaves (3 stacked 120 x 160 frames, 6
    actions): 21.6M parameters."""
    if not _CNN_SHAPES:
        net = CnnActorCritic((360, 160, 3), 6, generator=torch.Generator().manual_seed(0))
        _CNN_SHAPES.append({k: tuple(v.shape) for k, v in net.state_dict().items()})
    return _CNN_SHAPES[0]


def card_state(net, seed, clip, device, **kw):
    shapes = V0_SHAPES if net == "v0" else cnn_shapes()
    params, grads, opt = draw(shapes, seed, SCALES[clip], device=device, **kw)
    if net == "cnn":  # autograd gives the convolutions' weight gradients channels-last
        grads = [g.to(memory_format=torch.channels_last) if g.dim() == 4 else g for g in grads]
    return params, grads, opt


@pytest.mark.cuda
@pytest.mark.parametrize("clip", ["inactive", "active"])
@pytest.mark.parametrize("net", ["v0", "cnn"])
def test_kernel_against_plain_on_card(cuda_device, net, clip):
    hp = hparams(cuda_device)
    params, grads, opt = card_state(net, 5, clip, cuda_device, count=41)
    stop, kl, kl_last = scalars(cuda_device, kl=0.004, kl_last=0.002)
    before = cb.launch_count("adam_fused")
    got = tppo.adam_freeze_step(params, grads, opt, stop, kl, kl_last, hp)
    torch.cuda.synchronize()
    assert cb.launch_count("adam_fused") == before + 2
    want = tppo.adam_freeze_plain(params, grads, opt, stop, kl, kl_last, hp)
    if clip == "inactive":
        assert_bitwise(leaves(got), leaves(want))
    else:
        assert_close_to_leaf_scale(leaves(got), leaves(want))
    assert not bool(got[2]) and int(got[1].count) == 42


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["v0", "cnn"])
def test_frozen_step_returns_its_inputs_on_card(cuda_device, net):
    hp = hparams(cuda_device)
    params, grads, opt = card_state(net, 6, "active", cuda_device)
    stop, kl, kl_last = scalars(cuda_device, stop=True, kl=0.5, kl_last=0.003)
    got = tppo.adam_freeze_step(params, grads, opt, stop, kl, kl_last, hp)
    assert_bitwise(leaves(got), leaves((params, opt, stop, kl_last)))


@pytest.mark.cuda
def test_kernel_is_deterministic_on_card(cuda_device):
    hp = hparams(cuda_device)
    params, grads, opt = card_state("cnn", 7, "active", cuda_device)
    stop, kl, kl_last = scalars(cuda_device, kl=0.004)
    assert_deterministic(lambda: leaves(tppo.adam_freeze_step(params, grads, opt, stop, kl,
                                                              kl_last, hp)), n=3)


@pytest.mark.cuda
def test_graph_replay_equals_eager_launch_on_card(cuda_device):
    hp = hparams(cuda_device)
    params, grads, opt = card_state("v0", 8, "active", cuda_device)
    stop, kl, kl_last = scalars(cuda_device, kl=0.02)
    eager = leaves(tppo.adam_freeze_step(params, grads, opt, stop, kl, kl_last, hp))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as torch's capture wants
        tppo.adam_freeze_step(params, grads, opt, stop, kl, kl_last, hp)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = leaves(tppo.adam_freeze_step(params, grads, opt, stop, kl, kl_last, hp))
    for x in captured:
        x.fill_(0)
    graph.replay()
    torch.cuda.synchronize()
    assert_bitwise(captured, eager)
    assert bool(captured[-2]) and int(captured[-3]) == 4


@pytest.mark.cuda
def test_launches_per_learner_replay_on_card(cuda_device):
    cfg = PPOConfig(n_envs=256, n_steps=8, batch_size=512, n_epochs=2, target_kl=5e-4)
    algo = PPO(cfg, device=cuda_device)
    ts = algo.init_state()
    ts, _m = algo.train_step(ts)
    per_replay = 2 * cfg.n_epochs * (cfg.n_envs * cfg.n_steps // cfg.batch_size)
    # beside the minibatch gradient chain's four launches per minibatch
    assert algo.graph_launches["learner"] == {"adam_fused": per_replay, "mlp_grad": 2 * per_replay}
    before = cb.launch_count("adam_fused")
    ts, _m = algo.train_step(ts)
    assert cb.launch_count("adam_fused") - before == per_replay


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take_on_card(cuda_device):
    hp = hparams(cuda_device)
    params, grads, opt = draw(V0_SHAPES, 9, 1.0, device=cuda_device)
    stop, kl, kl_last = scalars(cuda_device)
    sc = (hp.learning_rate, hp.max_grad_norm, hp.target_kl, opt.count, stop, kl, kl_last)
    def run(p, g, mu):
        return adam_fused.launch(p, g, mu, opt.nu, sc, tppo._KERNEL_CONSTS, tppo._ADAM_DECAYS)

    key = "trunk.1.weight"
    i = list(params).index(key)
    strided = [g.t().contiguous().t() if k == key else g for k, g in zip(params, grads)]
    with pytest.raises(ValueError, match="contiguous"):
        run(params, strided, opt.mu)
    with pytest.raises(ValueError, match="float32"):
        run(dict(params, **{key: params[key].double()}), grads, opt.mu)
    with pytest.raises(ValueError):
        run(params, grads[:i] + grads[i + 1:], opt.mu)
    with pytest.raises(ValueError):
        run(params, grads, dict(opt.mu, **{key: opt.mu[key].cpu()}))
    run(params, grads, opt.mu)  # and the same inputs in their right form launch
    torch.cuda.synchronize()
