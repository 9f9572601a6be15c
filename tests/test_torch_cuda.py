"""The port's CUDA kernels on the GPU, against their plain versions.

Marked ``cuda``: they skip where no GPU exists.  On a GPU machine (which
need not have jax):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.channel import ChannelConfig, LinkPlan
from repro_torch.channel.payload import LinkConfig
from repro_torch.core.graphs import StepGraph
from repro_torch.core.program import ProgramOptions
from repro_torch.core.protocols import (FederatedConfig, FederatedTrainer,
                                        make_local_train)
from repro_torch.core.sampling import ChurnConfig, SamplerConfig
from repro_torch.core.seed_prep import summarize_seeds
from repro_torch.data import (PartitionSpec, parse_task, partition_iid,
                              synthetic_images)
from repro_torch.kernels import runtime
from repro_torch.kernels import ops
from repro_torch.kernels.distill_loss import (distill_loss,
                                              distill_loss_plain,
                                              distill_phi_psi,
                                              distill_step,
                                              distill_step_plain,
                                              phi_psi_bwd_plain,
                                              phi_psi_plain)
from repro_torch.kernels.flash_attention import (BUILT,
                                                 attention_plain,
                                                 bf16_excess,
                                                 flash_attention)
from repro_torch.kernels.mixup_kernel import mixup, mixup_plain
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.launch.serve import serve
from repro_torch.launch.service import FederatedService, InferenceEndpoint
from repro_torch.models import CNN

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,f", [(100, 784), (33, 17), (1, 1)])
def test_mixup_kernel_matches_plain(gpu, n, f):
    g = torch.Generator(device=gpu).manual_seed(n)
    a, b = (torch.rand(n, f, generator=g, device=gpu) for _ in range(2))
    la = torch.full((n,), -0.125, device=gpu)
    before = runtime.KERNELS["mixup"].launches
    got = mixup(a, b, la, 1.0 - la)
    torch.cuda.synchronize()
    assert runtime.KERNELS["mixup"].launches == before + 1
    torch.testing.assert_close(got, mixup_plain(a, b, la, 1.0 - la),
                               rtol=0, atol=1e-5)
    got16 = mixup(a.bfloat16(), b.bfloat16(), la, 1.0 - la)
    want16 = mixup_plain(a.bfloat16(), b.bfloat16(), la, 1.0 - la)
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16.float(), want16.float(), rtol=8e-3,
                               atol=0)


# (100, 3072) and (100, 1280): the cifar and speech rows of the Fig. 2
# seed exchange (10 devices x 10 seeds)
@pytest.mark.parametrize("n,f", [(7, 3), (9, 5), (5, 1023), (100, 784),
                                 (100, 3072), (100, 1280), (37, 1280)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixup_kernel_is_bit_equal_to_plain(gpu, n, f, dtype):
    """Widths off the 16-byte vector (the scalar ends of a row), odd F in
    bfloat16, and row slices of a larger tensor, whose bases lie off a
    16-byte boundary unless 16 bytes divide a row: every element equal
    to the plain version's."""
    g = torch.Generator(device=gpu).manual_seed(f)
    big_a, big_b = (torch.rand(n + 2, f, generator=g, device=gpu).to(dtype)
                    for _ in range(2))
    la = torch.rand(n, generator=g, device=gpu) * 2.0 - 0.5
    for a, b in ((big_a[:n], big_b[:n]), (big_a[1:n + 1], big_b[2:])):
        assert a.is_contiguous() and b.is_contiguous()
        before = runtime.KERNELS["mixup"].launches
        got = mixup(a, b, la, 1.0 - la)
        torch.cuda.synchronize()
        assert runtime.KERNELS["mixup"].launches == before + 1
        assert got.dtype == dtype
        assert torch.equal(got, mixup_plain(a, b, la, 1.0 - la))


@pytest.mark.parametrize("n,c", [(160, 10), (33, 12), (7, 70)])
def test_distill_kernels_match_plain(gpu, n, c):
    g_ = torch.Generator(device=gpu).manual_seed(c)
    z = (2 * torch.randn(n, c, generator=g_, device=gpu)).requires_grad_()
    y = torch.randint(0, c, (n,), generator=g_, device=gpu)
    g = torch.softmax(torch.randn(n, c, generator=g_, device=gpu), -1)
    g[0] = 0.0
    g = g.requires_grad_()
    phi, psi = distill_phi_psi(z, y, g)
    (phi.sum() + 0.5 * psi.sum()).backward()
    torch.cuda.synchronize()
    want = phi_psi_plain(z.detach(), y, g.detach())
    torch.testing.assert_close((phi, psi), want, rtol=0, atol=1e-5)
    dz, dg = phi_psi_bwd_plain(z.detach(), y, g.detach(),
                               torch.ones(n, device=gpu),
                               torch.full((n,), 0.5, device=gpu))
    torch.testing.assert_close(z.grad, dz, rtol=0, atol=1e-5)
    torch.testing.assert_close(g.grad, dg, rtol=0, atol=1e-5)


def test_kernels_refuse_what_they_do_not_take(gpu):
    a = torch.rand(4, 5, device=gpu, dtype=torch.float64)
    la = torch.rand(4, device=gpu)
    with pytest.raises(ValueError):
        mixup(a, a, la, la)
    with pytest.raises(ValueError):
        mixup(a.float().t(), a.float().t(), torch.rand(5, device=gpu),
              torch.rand(5, device=gpu))
    with pytest.raises(ValueError):
        mixup(a.float(), a.float().cpu(), la, la)


def test_trainer_on_gpu_matches_cpu(gpu):
    x, y = synthetic_images(rng.PRNGKey(42), 1400, device="cpu")
    dev_x, dev_y = partition_iid(x[:1200], y[:1200], 4, 300, 10, seed=0)
    fc = FederatedConfig(protocol="mix2fld", num_devices=4, local_iters=8,
                         local_batch=16, server_iters=8, server_batch=16,
                         max_rounds=2, n_seed=6, n_inverse=12)
    ch = ChannelConfig(num_devices=4, p_up_dbm=40.0)
    runtime.reset_launch_counts()
    tr = FederatedTrainer(CNN(), fc, ch, device=gpu)
    h_gpu = tr.run(dev_x, dev_y, x[1200:], y[1200:])
    counts = runtime.launch_counts()
    h_cpu = FederatedTrainer(CNN(), fc, ch, device="cpu").run(
        dev_x, dev_y, x[1200:], y[1200:])
    # 2 rounds x 8 local steps: the first graph's warm-up steps, then
    # replays of the captured step
    assert counts["mixup"] >= 3 and counts["distill_step"] == 16
    (g,) = tr.local_train.graphs
    assert g.warm_steps + g.replays == 16 and g.replays > 0
    assert (g.warmed["distill_step"] + g.captured["distill_step"] * g.replays
            == 16)
    np.testing.assert_allclose(h_gpu["loss"], h_cpu["loss"], atol=1e-4)
    np.testing.assert_allclose(h_gpu["acc"], h_cpu["acc"], atol=1e-4)
    assert h_gpu["round_latency_s"] == h_cpu["round_latency_s"]


def _step_inputs(gpu, D, B, C, seed, odd_rows=False):
    g_ = torch.Generator(device=gpu).manual_seed(seed)
    z = 2 * torch.randn(D, B, C, generator=g_, device=gpu)
    y = torch.randint(0, C, (D, B), generator=g_, device=gpu)
    gout = torch.softmax(torch.randn(D, C, C, generator=g_, device=gpu), -1)
    if odd_rows:
        gout[:, 0] = 0.0                                    # zero rows
        gout[:, 1:C // 2] *= 3.0                            # unnormalised
    sums = (torch.randn(D, 7, generator=g_, device=gpu),
            torch.rand(D, C, C, generator=g_, device=gpu),
            torch.randint(0, 4, (D, C), generator=g_, device=gpu).float())
    return z, y, gout, sums


# the phase-4 shapes of chip_smoke.py: the main path's (10, 16, 10) with
# and without KD, the CPU tests' (4, 16, 10), an odd (3, 5, 12), zero
# and unnormalised G_out rows, and the Fig. 2 path's (10, 32, 10), a
# mixed cohort's or a sampled cohort's (5, 32, 10) and speech's
# (10, 32, 12)
@pytest.mark.parametrize("D,B,C,beta,odd_rows", [
    (10, 16, 10, 0.0, False), (10, 16, 10, 0.01, False),
    (4, 16, 10, 0.01, False), (3, 5, 12, 0.01, False),
    (10, 16, 10, 0.01, True), (10, 32, 10, 0.01, False),
    (5, 32, 10, 0.0, False), (5, 32, 10, 0.01, True),
    (10, 32, 12, 0.01, False)])
def test_distill_step_kernel_matches_plain(gpu, D, B, C, beta, odd_rows):
    z, y, gout, sums = _step_inputs(gpu, D, B, C, D + B + C, odd_rows)
    mine = [t.clone() for t in sums]
    want = [t.clone() for t in sums]
    b = torch.tensor([beta], device=gpu)
    k = torch.tensor([4], device=gpu)
    before = runtime.KERNELS["distill_step"].launches
    dz = distill_step(z, y, gout, b, k, *mine)
    torch.cuda.synchronize()
    assert runtime.KERNELS["distill_step"].launches == before + 1
    wdz = distill_step_plain(z, y, gout, b, k, *want)
    torch.testing.assert_close(dz, wdz, rtol=0, atol=1e-5)
    for got, w in zip(mine, want):
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("K", [1, 2, 8])
def test_local_train_on_gpu_matches_cpu(gpu, K):
    """The captured step against the CPU's eager one, also with fewer
    steps than the graph's warm-up (which reads only the run's steps)."""
    D, C, B = 3, 10, 16
    g = torch.Generator().manual_seed(K)
    x = torch.rand(D, 40, 28, 28, 1, generator=g)
    y = torch.randint(0, C, (D, 40), generator=g)
    cnn = CNN()
    p = cnn.init(rng.PRNGKey(1))
    params = {k: {m: t.expand((D,) + t.shape).clone() for m, t in v.items()}
              for k, v in p.items()}
    gout = torch.softmax(torch.randn(D, C, C, generator=g), -1)
    keys = rng.split(rng.PRNGKey(3), D)
    outs = []
    for d in (gpu, torch.device("cpu")):
        lt = make_local_train(cnn.apply_stacked, C, K, B)
        mv = {k: {m: t.to(d) for m, t in v.items()} for k, v in params.items()}
        got = lt(mv, x.to(d), y.to(d), keys.to(d), gout.to(d), True, 0.01,
                 0.01, 40)
        outs.append([t.cpu() for v in got[0].values() for t in v.values()]
                    + [t.cpu() for t in got[1:]])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_a_round_state_outlives_the_next_round(gpu):
    """The step graphs' static buffers are reused every round: a round's
    returned state (FD returns the trained device parameters as they
    are) must not change when the next round runs."""
    x, y = synthetic_images(rng.PRNGKey(42), 1400, device=gpu)
    dev_x, dev_y = (torch.as_tensor(a, device=gpu) for a in partition_iid(
        x[:1200], y[:1200], 4, 300, 10, seed=0))
    for proto in ("fd", "mix2fld"):
        fc = FederatedConfig(protocol=proto, num_devices=4, local_iters=8,
                             local_batch=16, server_iters=8,
                             server_batch=16, max_rounds=3, n_seed=6,
                             n_inverse=12)
        tr = FederatedTrainer(CNN(), fc, ChannelConfig(num_devices=4,
                                                       p_up_dbm=40.0),
                              device=gpu)
        state = tr.init_state(4)
        state, _ = tr.round_once(state, dev_x, dev_y, x[1200:], y[1200:])
        kept = {f: {k: {m: t.clone() for m, t in v.items()}
                    for k, v in getattr(state, f).items()}
                for f in ("dev_params", "g_params")}
        nxt, _ = tr.round_once(state, dev_x, dev_y, x[1200:], y[1200:])
        torch.cuda.synchronize()
        for f, tree in kept.items():
            for k, v in tree.items():
                for m, t in v.items():
                    assert torch.equal(getattr(state, f)[k][m], t), (
                        proto, f, k, m)
        assert not torch.equal(nxt.dev_params["fc"]["w"],
                               state.dev_params["fc"]["w"])
        assert all(g.replays > 0 for g in tr.local_train.graphs)


# bf16: the kernel rounds the running-max probabilities, the plain
# version the normalised ones, both round the output: 2 bf16 ulps, |o|<=4;
# and bf16_excess <= 1, a bound per element that scales with the row
@pytest.mark.parametrize("bh,s,d,dtype,window,atol", [
    (56, 1024, 64, torch.bfloat16, None, 2 * 2.0 ** -6),  # serve prefill
    (8, 100, 64, torch.float32, None, 2e-5),              # ragged tail
    (8, 512, 64, torch.bfloat16, 128, 2 * 2.0 ** -6),     # sliding window
    (8, 256, 32, torch.float32, None, 2e-5),
    (4, 300, 128, torch.float32, 7, 2e-5),
    (2, 1, 32, torch.float32, None, 2e-5),
    (128, 1024, 80, torch.bfloat16, 4096, 2 * 2.0 ** -6),  # zamba2 prefill
    (8, 160, 80, torch.float32, 128, 2e-5),   # its width-80 smoke variant
    (4, 300, 80, torch.float32, 7, 2e-5),
    (2000, 16, 16, torch.float32, None, 2e-5),  # transformer classifier
    (4, 300, 16, torch.float32, 7, 2e-5),
    (128, 1024, 96, torch.bfloat16, None, 2 * 2.0 ** -6),  # phi3 prefill
    (64, 8192, 120, torch.bfloat16, 4096, 2 * 2.0 ** -6),  # danube3's
    (160, 1024, 128, torch.bfloat16, None, 2 * 2.0 ** -6),  # qwen3-14b's
    (64, 1024, 128, torch.bfloat16, None, 2 * 2.0 ** -6),   # qwen2-moe's
    (8, 64, 96, torch.float32, None, 2e-5),     # the width-96 variant
    (8, 300, 96, torch.float32, 7, 2e-5),
    (8, 160, 120, torch.float32, 128, 2e-5),    # the width-120 variant
    (8, 300, 120, torch.float32, None, 2e-5),
])
def test_flash_attention_kernel_matches_plain(gpu, bh, s, d, dtype, window,
                                              atol):
    g = torch.Generator(device=gpu).manual_seed(s)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=gpu).to(dtype)
               for _ in range(3))
    before = runtime.KERNELS["flash_attention"].launches
    got = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert runtime.KERNELS["flash_attention"].launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (bh, s, d)
    # the plain version a few heads at a time: (8, S, S) float32 scores
    want = torch.cat([attention_plain(q[i:i + 8], k[i:i + 8], v[i:i + 8],
                                      window) for i in range(0, bh, 8)])
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    if dtype == torch.bfloat16:   # and per element, scaled to its row
        assert bf16_excess(got, want) <= 1


@pytest.mark.parametrize("wrong", [None, 4032, 4095])
def test_flash_attention_bf16_bound_rejects_a_wrong_window(gpu, wrong):
    """At h2o-danube3's prefill call, the kernel run over a wrong key
    set (keys past the window of 4096 kept; 64 or 1 key of it dropped)
    fails the per-element bound that its right output meets."""
    g = torch.Generator(device=gpu).manual_seed(4096)
    q, k, v = (torch.randn(64, 8192, 120, generator=g, device=gpu)
               .bfloat16() for _ in range(3))
    want = torch.cat([attention_plain(q[i:i + 8], k[i:i + 8], v[i:i + 8],
                                      4096) for i in range(0, 64, 8)])
    assert bf16_excess(flash_attention(q, k, v, window=4096), want) <= 1
    assert bf16_excess(flash_attention(q, k, v, window=wrong), want) > 1


# bfloat16 runs on the tensor-core kernel (128-query, 128-key tiles):
# head dims, lengths off the tile, windows and batch sizes, each against
# the plain version at the bf16 tolerance above
@pytest.mark.parametrize("bh,s,d,dv,window", [
    (4, 256, 32, 32, None),
    (4, 256, 128, 128, None),
    (4, 256, 64, 128, None),
    (4, 256, 128, 32, None),
    (2, 1, 64, 64, None),
    (3, 70, 64, 64, None),
    (3, 127, 32, 32, None),
    (3, 129, 128, 128, None),
    (2, 1000, 64, 64, None),
    (4, 512, 64, 64, 1),
    (4, 512, 64, 64, 128),
    (4, 512, 128, 128, 128),
    (1, 1024, 64, 64, None),
    (57, 256, 64, 64, None),
    (3, 129, 80, 80, None),       # head dim 80: the 128-column tile
    (4, 512, 80, 80, 128),
    (2, 1, 80, 80, None),
    (4, 256, 80, 64, None),
    (4, 256, 64, 80, None),
    (3, 129, 96, 96, None),       # head dims 96 and 120: the same tile
    (4, 512, 96, 96, 128),
    (3, 129, 120, 120, 64),
    (4, 300, 120, 120, None),
    (2, 1, 120, 120, None),
    (4, 256, 120, 64, None),
])
def test_flash_attention_bf16_kernel_matches_plain(gpu, bh, s, d, dv,
                                                   window):
    g = torch.Generator(device=gpu).manual_seed(s + d)
    q, k = (torch.randn(bh, s, d, generator=g, device=gpu).bfloat16()
            for _ in range(2))
    v = torch.randn(bh, s, dv, generator=g, device=gpu).bfloat16()
    before = runtime.KERNELS["flash_attention"].launches
    got = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert runtime.KERNELS["flash_attention"].launches == before + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (bh, s, dv)
    want = attention_plain(q, k, v, window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2 * 2.0 ** -6)
    assert bf16_excess(got, want) <= 1


def test_flash_attention_refuses_misaligned_bf16(gpu):
    buf = torch.randn(2 * 64 * 64 + 1, device=gpu).bfloat16()
    q = buf[1:].view(2, 64, 64)          # contiguous, 2 bytes off 16
    assert q.is_contiguous()
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("n,c", [(160, 10), (33, 12), (1000, 10)])
def test_distill_loss_kernel_matches_plain(gpu, n, c):
    g_ = torch.Generator(device=gpu).manual_seed(n)
    z = 2 * torch.randn(n, c, generator=g_, device=gpu)
    y = torch.randint(0, c, (n,), generator=g_, device=gpu)
    gout = torch.softmax(torch.randn(c, c, generator=g_, device=gpu), -1)
    before = runtime.KERNELS["distill_loss"].launches
    per = distill_loss(z, y, gout[y], 0.01)
    mean = ops.distill_loss(z, y, gout, 0.01)
    torch.cuda.synchronize()
    assert runtime.KERNELS["distill_loss"].launches == before + 2
    want = distill_loss_plain(z, y, gout[y], 0.01)
    torch.testing.assert_close(per, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(mean, want.mean(), rtol=0, atol=1e-5)


def test_serve_smoke_on_gpu_matches_cpu(gpu):
    runtime.reset_launch_counts()
    got = serve("qwen2-0.5b", 2, 64, 6, smoke=True, device=gpu)
    assert runtime.launch_counts()["flash_attention"] == 2   # two layers
    want = serve("qwen2-0.5b", 2, 64, 6, smoke=True, device="cpu")
    assert torch.equal(got.cpu(), want)


def _ssd_inputs(gpu, bh, s, p, n, hpg, seed):
    g = torch.Generator(device=gpu).manual_seed(seed)
    xdt = 0.5 * torch.randn(bh, s, p, generator=g, device=gpu)
    B, C = (0.5 * torch.randn(bh // hpg, s, n, generator=g, device=gpu)
            for _ in range(2))
    dA = -torch.nn.functional.softplus(
        torch.randn(bh, s, generator=g, device=gpu))
    return xdt, B, C, dA


# the reference's own tolerance for its SSD kernel (float32, another
# summation order and cumsum)
SSD_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("bh,s,p,n,chunk,hpg", [
    (128, 1024, 64, 128, 256, 32),   # mamba2-370m prefill, batch 4
    (32, 64, 32, 16, 32, 16),        # mamba2-370m smoke, prompt 40 padded
    (8, 512, 64, 128, 128, 1),       # a chunk below 256
    (1, 256, 64, 128, 256, 1),       # one row
    (2, 128, 32, 16, 32, 1),         # the reference's kernel test shapes
    (4, 256, 64, 32, 64, 1),
    (1, 64, 16, 8, 16, 1),
    (6, 96, 8, 4, 96, 2),            # a chunk that is no multiple of 64
    (320, 1024, 64, 64, 256, 80),    # zamba2-2.7b prefill, batch 4
    (16, 160, 64, 64, 32, 8),        # its width-80 smoke variant
])
def test_ssd_scan_kernel_matches_plain(gpu, bh, s, p, n, chunk, hpg):
    xdt, B, C, dA = _ssd_inputs(gpu, bh, s, p, n, hpg, s + p)
    before = runtime.KERNELS["ssd_scan"].launches
    y, state = ssd_scan(xdt, B, C, dA, chunk, final=True,
                        heads_per_group=hpg)
    y_only = ssd_scan(xdt, B, C, dA, chunk, heads_per_group=hpg)
    torch.cuda.synchronize()
    assert runtime.KERNELS["ssd_scan"].launches == before + 2
    want_y, want_state = ssd_scan_plain(xdt, B, C, dA, chunk, hpg)
    torch.testing.assert_close(y, want_y, **SSD_TOL)
    torch.testing.assert_close(state, want_state, **SSD_TOL)
    assert torch.equal(y, y_only)
    init = torch.randn(bh, n, p, device=gpu)
    y, state = ssd_scan(xdt, B, C, dA, chunk, final=True,
                        heads_per_group=hpg, initial_state=init)
    want_y, want_state = ssd_scan_plain(xdt, B, C, dA, chunk, hpg, init)
    torch.testing.assert_close(y, want_y, **SSD_TOL)
    torch.testing.assert_close(state, want_state, **SSD_TOL)


def test_ssd_scan_kernel_launches_once_and_frees_its_scratch(gpu):
    """One wrapper call is one count, whatever the kernel launches inside;
    the passes' scratch lives only for the call (the kernel allocates
    nothing), so what stays allocated is y and the final state."""
    bh, s, p, n, chunk, hpg = 128, 1024, 64, 128, 256, 32
    xdt, B, C, dA = _ssd_inputs(gpu, bh, s, p, n, hpg, 5)
    torch.cuda.synchronize()
    before_bytes = torch.cuda.memory_allocated(gpu)
    before = runtime.KERNELS["ssd_scan"].launches
    y, state = ssd_scan(xdt, B, C, dA, chunk, final=True,
                        heads_per_group=hpg)
    torch.cuda.synchronize()
    assert runtime.KERNELS["ssd_scan"].launches == before + 1
    assert (torch.cuda.memory_allocated(gpu) - before_bytes
            == y.untyped_storage().nbytes() + state.untyped_storage().nbytes())
    want_y, want_state = ssd_scan_plain(xdt, B, C, dA, chunk, hpg)
    torch.testing.assert_close(y, want_y, **SSD_TOL)
    torch.testing.assert_close(state, want_state, **SSD_TOL)


def test_ssd_scan_kernel_refuses_a_misaligned_base(gpu):
    """x, B and C are read by TMA, which needs 16-byte aligned data."""
    xdt, B, C, dA = _ssd_inputs(gpu, 2, 64, 8, 4, 1, 1)
    flat = torch.zeros(xdt.numel() + 1, device=gpu)
    flat[1:] = xdt.reshape(-1)
    off = flat[1:].view(xdt.shape)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    with pytest.raises(ValueError):
        ssd_scan(off, B, C, dA, 16)


def test_ssd_scan_kernel_keeps_rows_apart(gpu):
    """The state starts at zero for every row (the reference's
    test_ssd_kernel_state_isolated_between_batch_rows)."""
    g = torch.Generator(device=gpu).manual_seed(7)
    xdt, B, C = (torch.randn(3, 64, d, generator=g, device=gpu)
                 for d in (8, 4, 4))
    dA = -torch.randn(3, 64, generator=g, device=gpu).abs()
    full, fs = ssd_scan(xdt, B, C, dA, 16, final=True)
    solo, ss = ssd_scan(xdt[1:2], B[1:2], C[1:2], dA[1:2], 16, final=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(full[1], solo[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(fs[1], ss[0], rtol=0, atol=1e-5)


def test_ssd_scan_kernel_refuses_what_it_does_not_take(gpu):
    xdt, B, C, dA = _ssd_inputs(gpu, 2, 128, 32, 16, 1, 0)
    for args in (
            (xdt.double(), B.double(), C.double(), dA.double(), 32),
            (xdt, B, C, dA, 48),                      # S % chunk
            (xdt[:, :, :24].contiguous(), B, C, dA, 32),   # P = 24
            (*_ssd_inputs(gpu, 2, 64, 64, 48, 1, 0), 32),   # (P, N)
            (*_ssd_inputs(gpu, 2, 64, 32, 64, 1, 0), 32),   # not in
            (*_ssd_inputs(gpu, 2, 64, 128, 64, 1, 0), 32),  # SHAPES
            (xdt, B.transpose(0, 1).contiguous().transpose(0, 1), C, dA,
             32),                                     # not contiguous
            (xdt.repeat(1, 4, 1), B.repeat(1, 4, 1), C.repeat(1, 4, 1),
             dA.repeat(1, 4), 512)):                  # chunk > 256
        with pytest.raises(ValueError):
            ssd_scan(*args)
    with pytest.raises(ValueError):
        ssd_scan(xdt, B, C, dA.cpu(), 32)


@pytest.mark.parametrize("d,dv", [(16, 16), (48, 48), (112, 112),
                                  (192, 192), (192, 64)])
def test_flash_attention_refuses_head_dims_it_is_not_built_for(gpu, d, dv):
    """(d, dv) pairs outside ``BUILT`` raise on the card before a launch,
    in bfloat16 (16: the classifier's float32 dim; (48, 48): MLA's smoke
    d with another dv; (192, 192) and (192, 64): MLA's d with a dv it is
    not built for) and, outside the float32 pairs, in float32 (the plain
    version takes any)."""
    q = torch.randn(2, 64, d, device=gpu).bfloat16()
    v = torch.randn(2, 64, dv, device=gpu).bfloat16()
    before = runtime.KERNELS["flash_attention"].launches
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, v)
    if (d, dv) not in BUILT[torch.float32]:
        with pytest.raises(ValueError, match="head dims"):
            flash_attention(q.float(), q.float(), v.float())
    assert runtime.KERNELS["flash_attention"].launches == before


def test_flash_attention_built_pairs_mirror_the_library(gpu):
    """``BUILT[bfloat16]`` is the set of pairs that the library's
    ``flash_attention_layout`` reports a layout for, each with a K/V ring
    of at least two stages."""
    import ctypes
    import itertools

    runtime.build(["flash_attention.cu"])
    fn = runtime._LIBS["flash_attention.cu"].flash_attention_layout
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    stages = ctypes.c_int64()
    dims = (16, 32, 48, 64, 80, 96, 112, 120, 128, 192)
    laid = set()
    for d, dv in itertools.product(dims, dims):
        if fn(d, dv, ctypes.byref(stages)) > 0:
            laid.add((d, dv))
            assert stages.value >= 2, (d, dv, stages.value)
    assert laid == set(BUILT[torch.bfloat16])


# MLA (deepseek-v2): q.k 192 wide, values 128 (the serve's prefill call,
# (4 x 128 heads, 1024)), and the float32 smoke widths (48, 32) and
# (192, 128); the plain version 8 heads at a time
@pytest.mark.parametrize("bh,s,d,dv,dtype,window", [
    (512, 1024, 192, 128, torch.bfloat16, None),
    (3, 129, 192, 128, torch.bfloat16, None),
    (4, 300, 192, 128, torch.bfloat16, 64),
    (2, 1, 192, 128, torch.bfloat16, None),
    (8, 40, 48, 32, torch.float32, None),
    (8, 300, 48, 32, torch.float32, 7),
    (8, 160, 192, 128, torch.float32, None),
    (4, 300, 192, 128, torch.float32, 128),
])
def test_flash_attention_mla_pairs_match_plain(gpu, bh, s, d, dv, dtype,
                                               window):
    g = torch.Generator(device=gpu).manual_seed(s + d)
    q, k = (torch.randn(bh, s, d, generator=g, device=gpu).to(dtype)
            for _ in range(2))
    v = torch.randn(bh, s, dv, generator=g, device=gpu).to(dtype)
    before = runtime.KERNELS["flash_attention"].launches
    got = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert runtime.KERNELS["flash_attention"].launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (bh, s, dv)
    want = torch.cat([attention_plain(q[i:i + 8], k[i:i + 8], v[i:i + 8],
                                      window) for i in range(0, bh, 8)])
    atol = 2e-5 if dtype == torch.float32 else 2 * 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    if dtype == torch.bfloat16:
        assert bf16_excess(got, want) <= 1


def test_hybrid_serve_smoke_on_gpu_matches_cpu(gpu):
    runtime.reset_launch_counts()
    got = serve("zamba2-2.7b", 2, 160, 6, smoke=True, device=gpu)
    # one super-block: one attention call, two mamba layers
    assert runtime.launch_counts()["flash_attention"] == 1
    assert runtime.launch_counts()["ssd_scan"] == 2
    want = serve("zamba2-2.7b", 2, 160, 6, smoke=True, device="cpu")
    assert torch.equal(got.cpu(), want)


def test_hybrid_width80_on_gpu_matches_cpu(gpu):
    """The zamba2 smoke preset at head dim 80 and (P, N) = (64, 64), two
    super-blocks: the prefill goes through flash attention's float32
    route at d 80 and the SSD scan at (64, 64); the same greedy tokens as
    the CPU's, last-token logits within 1e-4."""
    from repro_torch.configs.zamba2_2_7b import width80_smoke
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import init_params

    cfg = width80_smoke()
    runtime.reset_launch_counts()
    got = serve(cfg, 2, 160, 6, device=gpu)
    assert runtime.launch_counts()["flash_attention"] == 2
    assert runtime.launch_counts()["ssd_scan"] == 4
    assert torch.equal(got.cpu(), serve(cfg, 2, 160, 6, device="cpu"))
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 160)))
    logits = []
    for dev in (gpu, "cpu"):
        with torch.inference_mode():
            params = init_params(cfg, rng.PRNGKey(0), device=dev)
            logits.append(make_prefill_step(cfg, 166)(
                params, {"tokens": toks.to(dev)})[0].cpu())
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch,prompt", [("qwen2-moe-a2.7b", 64),
                                         ("qwen3-14b", 64),
                                         ("h2o-danube-3-4b", 160)])
def test_family_serve_smoke_on_gpu_matches_cpu(gpu, arch, prompt):
    """The MoE, qk-norm and windowed smoke configs: B4 once a layer on
    the card, the same greedy tokens as the CPU's."""
    runtime.reset_launch_counts()
    got = serve(arch, 2, prompt, 6, smoke=True, device=gpu)
    assert runtime.launch_counts()["flash_attention"] == 2   # two layers
    want = serve(arch, 2, prompt, 6, smoke=True, device="cpu")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", ["width96", "width120", "moe_routing"])
def test_family_width_variants_on_gpu_match_cpu(gpu, case):
    """phi3's width-96 and danube3's width-120 smoke variants (window
    128, prompt 160): the prefill goes through flash attention's float32
    route at d 96 and d 120; and qwen2-moe's published routing (60
    experts, top 4, capacity factor 1.25: a group of 320 tokens, 28
    places an expert, drops).  The same greedy tokens as the CPU's,
    last-token logits within 1e-4."""
    from repro_torch.configs.h2o_danube3_4b import width120_smoke
    from repro_torch.configs.phi3_mini_3_8b import width96_smoke
    from repro_torch.configs.qwen2_moe_a2_7b import routing_smoke
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import init_params

    cfg = {"width96": width96_smoke, "width120": width120_smoke,
           "moe_routing": routing_smoke}[case]()
    runtime.reset_launch_counts()
    got = serve(cfg, 2, 160, 6, device=gpu)
    assert runtime.launch_counts()["flash_attention"] == 2
    assert torch.equal(got.cpu(), serve(cfg, 2, 160, 6, device="cpu"))
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 160)))
    logits = []
    for dev in (gpu, "cpu"):
        with torch.inference_mode():
            params = init_params(cfg, rng.PRNGKey(0), device=dev)
            logits.append(make_prefill_step(cfg, 166)(
                params, {"tokens": toks.to(dev)})[0].cpu())
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["smoke", "width192", "routing"])
def test_mla_on_gpu_matches_cpu(gpu, case):
    """deepseek-v2's smoke config (B4 float32 at (48, 32)), its width-192
    variant ((192, 128)) and its published routing (160 experts, top 6,
    capacity factor 1.25: a group of 320 tokens, 16 places an expert,
    drops): B4 once a layer, the same greedy tokens as the CPU's,
    last-token logits within 1e-4."""
    from repro_torch.configs import deepseek_v2_236b as ds
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import init_params, tree_map

    cfg = {"smoke": lambda: get_config("deepseek-v2-236b-smoke"),
           "width192": ds.width192_smoke,
           "routing": ds.routing_smoke}[case]()
    # one draw, on the card; the CPU runs a copy (the routing preset's
    # 329M parameters take minutes to draw on the CPU)
    with torch.inference_mode():
        params = {gpu: init_params(cfg, rng.PRNGKey(0), device=gpu)}
    params["cpu"] = tree_map(lambda t: t.cpu(), params[gpu])
    runtime.reset_launch_counts()
    got = serve(cfg, 2, 160, 6, device=gpu, params=params[gpu])
    assert runtime.launch_counts()["flash_attention"] == 2
    assert torch.equal(got.cpu(), serve(cfg, 2, 160, 6, device="cpu",
                                        params=params["cpu"]))
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 160)))
    logits = []
    for dev in (gpu, "cpu"):
        with torch.inference_mode():
            logits.append(make_prefill_step(cfg, 166)(
                params[dev], {"tokens": toks.to(dev)})[0].cpu())
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=1e-4)


@pytest.mark.parametrize("bh,s,d", [(8, 1024, 128), (8, 1024, 64)],
                         ids=["qwen2-vl", "whisper"])
def test_flash_attention_bf16_at_the_vlm_and_audio_calls(gpu, bh, s, d):
    """B4 at the qwen2-vl (256, 1024, 128) and whisper (64, 1024, 64)
    prefill calls, on 8 of their heads: within 2 bf16 ulps of the plain
    version and ``bf16_excess`` <= 1."""
    g = torch.Generator(device=gpu).manual_seed(d)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=gpu).bfloat16()
               for _ in range(3))
    got = flash_attention(q, k, v)
    want = attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2 * 2.0 ** -6)
    assert bf16_excess(got, want) <= 1


def _vlm_steps(cfg, device, prompt=40, gen=6):
    """qwen2-vl's smoke config through the steps with stub embeddings:
    the prefill's last-token logits and the greedy tokens."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_params

    with torch.inference_mode():
        params = init_params(cfg, rng.PRNGKey(0), device=device)
        emb = rng.normal(rng.PRNGKey(1, device),
                         (2, prompt + gen, cfg.d_model)) * 0.1
        logits, cache = make_prefill_step(cfg, prompt + gen)(
            params, {"embeds": emb[:, :prompt]})
        toks = [torch.argmax(logits, -1)]
        for t in range(prompt, prompt + gen - 1):
            nxt, cache = make_decode_step(cfg)(
                params, {"embeds": emb[:, t:t + 1], "cache": cache})
            toks.append(nxt)
    return logits.cpu(), torch.stack(toks, 1).cpu()


@pytest.mark.parametrize("case", ["vlm", "audio", "kv_int8"])
def test_vlm_audio_and_int8_smoke_on_gpu_match_cpu(gpu, case):
    """qwen2-vl (M-RoPE over embeddings, through the steps), whisper
    (cross-attention, through serve) and qwen2-0.5b with the int8 cache
    (through serve), float32 smoke configs: B4 once a layer on the card,
    the same greedy tokens as the CPU's, last-token logits within
    1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.launch.serve import stub_encoder
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import init_params

    runtime.reset_launch_counts()
    if case == "vlm":
        cfg = get_config("qwen2-vl-72b-smoke")
        (lg, got), (lc, want) = (_vlm_steps(cfg, d) for d in (gpu, "cpu"))
        assert runtime.launch_counts()["flash_attention"] == 2
        assert torch.equal(got, want)
        torch.testing.assert_close(lg, lc, rtol=0, atol=1e-4)
        return
    cfg = (get_config("whisper-medium-smoke") if case == "audio" else
           dataclasses.replace(get_config("qwen2-0.5b-smoke"), kv_quant=True))
    got = serve(cfg, 2, 40, 6, device=gpu)
    assert runtime.launch_counts()["flash_attention"] == 2
    assert torch.equal(got.cpu(), serve(cfg, 2, 40, 6, device="cpu"))
    logits = []
    for dev in (gpu, "cpu"):
        with torch.inference_mode():
            params = init_params(cfg, rng.PRNGKey(0), device=dev)
            toks = synthetic_tokens(rng.PRNGKey(1), 2, 40, cfg.vocab_size,
                                    device=dev)
            logits.append(make_prefill_step(cfg, 46)(params, dict(
                stub_encoder(cfg, 2, dev), tokens=toks))[0].cpu())
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=1e-4)


def test_int8_cache_on_gpu_matches_cpu(gpu):
    """qwen2-0.5b's smoke config with ``kv_quant``: the prefill's int8
    cache and three decode steps' writes on the card and on the CPU.  The
    values are equal but where the two sides' float32 k/v (another
    summation order) round across a boundary: then off by one, in under
    0.1% of them; the scales within 1e-5 of their size."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config("qwen2-0.5b-smoke"), kv_quant=True)
    caches = []
    for dev in (gpu, "cpu"):
        with torch.inference_mode():
            params = init_params(cfg, rng.PRNGKey(0), device=dev)
            toks = synthetic_tokens(rng.PRNGKey(1), 2, 64, cfg.vocab_size,
                                    device=dev)
            _, cache = make_prefill_step(cfg, 70)(params, {"tokens": toks})
            for t in range(3):
                _, cache = make_decode_step(cfg)(
                    params, {"tokens": toks[:, t:t + 1], "cache": cache})
        caches.append({k: v.cpu() for k, v in cache["layers"].items()})
    for k in ("k", "v"):
        assert caches[0][k].dtype == torch.int8
        d = (caches[0][k].int() - caches[1][k].int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3
        sc = caches[1][k + "_scale"]
        assert bool(((caches[0][k + "_scale"] - sc).abs() <= 1e-5 * sc).all())


def test_mamba2_serve_smoke_on_gpu_matches_cpu(gpu):
    runtime.reset_launch_counts()
    got = serve("mamba2-370m", 2, 40, 6, smoke=True, device=gpu)
    assert runtime.launch_counts()["ssd_scan"] == 2   # two layers
    want = serve("mamba2-370m", 2, 40, 6, smoke=True, device="cpu")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kw", [
    dict(protocol="mix2fld", model="cnn+mlp"),
    dict(protocol="fl", sampler=SamplerConfig(0.5),
         channel=LinkConfig("quantize8")),
    dict(protocol="mix2fld", channel=LinkConfig("dp_gaussian1.0"),
         model="mlp"),
    dict(protocol="fd", task="speech")])
def test_fig2_configs_on_gpu_match_cpu(gpu, kw):
    """The Fig. 2 slice's configs: card against CPU, each architecture
    group's local steps through its own captured graph."""
    task = parse_task(kw.get("task", "digits"))
    x, y = task.data(rng.PRNGKey(42), 1400, device="cpu")
    n_local = 4 + (task.num_classes - 2) * 29     # 2·2 + (C-2)·29
    dev_x, dev_y = PartitionSpec("noniid", n_local=n_local).build(
        x[:1200], y[:1200], 4, task.num_classes)
    fc = FederatedConfig(num_devices=4, local_iters=8, local_batch=32,
                         server_iters=8, server_batch=32, max_rounds=2,
                         n_seed=6, n_inverse=12, **kw)
    ch = ChannelConfig(num_devices=4, p_up_dbm=40.0)
    runtime.reset_launch_counts()
    tr = FederatedTrainer(None, fc, ch, device=gpu)
    h_gpu = tr.run(dev_x, dev_y, x[1200:], y[1200:])
    counts = runtime.launch_counts()
    h_cpu = FederatedTrainer(None, fc, ch, device="cpu").run(
        dev_x, dev_y, x[1200:], y[1200:])
    groups = len(fc.arch_groups() or [None])
    assert counts["distill_step"] == 2 * 8 * groups
    assert len(tr.local_graphs) == groups
    assert all(g.replays > 0 for g in tr.local_graphs)
    np.testing.assert_allclose(h_gpu["loss"], h_cpu["loss"], atol=1e-4)
    np.testing.assert_allclose(h_gpu["acc"], h_cpu["acc"], atol=1e-4)
    for k in ("round_latency_s", "uplink_ok", "dp_epsilon"):
        assert h_gpu.get(k) == h_cpu.get(k), k


def _service(device, **kw):
    x, y = synthetic_images(rng.PRNGKey(42), 1400, device="cpu")
    dev_x, dev_y = partition_iid(x[:1200], y[:1200], 4, 300, 10, seed=0)
    fc = FederatedConfig(protocol="mix2fld", num_devices=4, local_iters=8,
                         local_batch=16, server_iters=8, server_batch=16,
                         n_seed=6, n_inverse=12)
    ch = ChannelConfig(num_devices=4, p_up_dbm=40.0, compute_mean_s=0.05,
                       deadline_s=0.08)
    svc = FederatedService(
        None, fc, ch, churn=ChurnConfig(p_active=0.6, min_active=2, seed=3),
        options=ProgramOptions(pipeline_depth=2), device=device, **kw)
    return svc.bind_data(dev_x, dev_y, x[1200:], y[1200:])


def test_service_rounds_on_gpu_match_cpu(gpu, tmp_path):
    """Churn, stragglers and the depth-2 window on the card against the
    CPU; then a restore on the card continues its own run bit for bit
    (the service's rounds run cuDNN's deterministic algorithms)."""
    runtime.reset_launch_counts()
    svc = _service(gpu, ckpt_dir=str(tmp_path))
    got = svc.run_rounds(4)
    counts = runtime.launch_counts()
    want = _service("cpu").run_rounds(4)
    # round 1's exchange: the devices' Mixup, and one launch for each
    # side of the inverse-Mixup when the uploads hold symmetric pairs
    pairs = "2" in summarize_seeds(svc.state.seeds)["cycle_hist"]
    assert counts["mixup"] == 1 + 2 * pairs
    assert counts["distill_step"] == 4 * 8
    assert len({r["n_active"] for r in got}) > 1
    for g, w in zip(got, want):
        for k in ("round", "uplink_ok", "n_straggle", "n_active"):
            assert g[k] == w[k], k
        np.testing.assert_array_equal(g["active"], w["active"])
        np.testing.assert_allclose(g["loss"], w["loss"], atol=1e-4)
        np.testing.assert_allclose(g["acc"], w["acc"], atol=1e-4)
        np.testing.assert_allclose(g["round_latency_s"],
                                   w["round_latency_s"], rtol=1e-6)
    again = _service(gpu, ckpt_dir=str(tmp_path))
    assert again.restore(step=2) == 2
    assert again.state.g_params["conv1"]["w"].device.type == "cuda"
    for g, w in zip(again.run_rounds(2), got[2:]):
        for k in ("uplink_ok", "n_straggle", "n_active",
                  "round_latency_s", "acc", "loss"):
            assert g[k] == w[k], k
    assert not torch.backends.cudnn.deterministic   # restored after


def test_side_stream_dispatch_collects_the_draw(gpu):
    """Draws dispatched on a side stream while the current stream is
    busy neither copy from the host nor wait for the card (torch.cuda's
    sync debug mode raises on either), and collect to the serial draw on
    the card, and to the CPU's."""
    plan = LinkPlan.build("mix2fld", ChannelConfig(
        num_devices=10, compute_mean_s=0.05, deadline_s=0.15),
        n_mod=12490, n_labels=10, sample_bits=6272, n_seed=10)
    keys = [rng.fold_in(rng.fold_in(rng.PRNGKey(0, gpu), q), 3)
            for q in range(1, 5)]
    a = torch.rand(2048, 2048, device=gpu)
    handles = []
    plan.draw(keys[0], first_round=True)    # makes the side stream
    for q, k in enumerate(keys):
        a = a @ a / 2048.0                  # the current stream is busy
        torch.cuda.set_sync_debug_mode("error")
        try:
            handles.append(plan.dispatch(k, first_round=q == 0))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert "event" in handles[-1]
    for q in (2, 0, 3, 1):
        got = plan.collect(handles[q])
        serial = plan.draw(keys[q], first_round=q == 0)
        cpu = plan.draw(keys[q].cpu(), first_round=q == 0)
        for k in ("up_ok", "dn_ok", "comp_ok"):
            np.testing.assert_array_equal(got[k], serial[k])
            np.testing.assert_array_equal(got[k], cpu[k])
        assert got["latency_s"] == serial["latency_s"]
        np.testing.assert_allclose(got["latency_s"], cpu["latency_s"],
                                   rtol=1e-6)
        assert got["t_up"].device.type == "cuda"


def test_endpoint_on_gpu_matches_cpu(gpu):
    model = CNN()
    params = model.init(rng.PRNGKey(0, gpu))
    x, _ = synthetic_images(rng.PRNGKey(1), 40, device="cpu")
    on_gpu = InferenceEndpoint(model.apply, 16, input_shape=(28, 28, 1),
                               device=gpu)
    on_cpu = InferenceEndpoint(model.apply, 16, input_shape=(28, 28, 1),
                               device="cpu")
    on_gpu.submit(x)
    on_cpu.submit(x)
    got = on_gpu.flush(params)
    want = on_cpu.flush({k: {n: t.cpu() for n, t in v.items()}
                         for k, v in params.items()})
    np.testing.assert_array_equal(got, want)
    assert on_gpu.batches == 3 and on_gpu.served == 40


def test_a_failed_capture_raises_and_does_not_run_eagerly(gpu):
    """A step that syncs with the host cannot be captured: the graph
    raises, and the step has run only its warm-up and the capture
    attempt, not the steps asked for.  (Last in the file: the failed
    capture is the last CUDA work of the process.)"""
    t = torch.zeros(1, device=gpu)
    calls = []

    def step():
        calls.append(1)
        t.add_(1)
        float(t.sum())        # a host sync, refused while capturing

    graph = StepGraph(step, torch.zeros(1, dtype=torch.int64, device=gpu))
    with pytest.raises(RuntimeError, match="capturing the step"):
        graph.run(t.zero_, 10)
    assert len(calls) == graph.warmup + 1
    assert graph.graph is None and graph.replays == 0


def test_distill_step_per_device_beta_on_gpu(gpu):
    """A beta per device row (a sweep group's G D rows, here 40) against
    the plain version; a beta of D equal values gives the one-beta
    kernel's results bit for bit."""
    g = torch.Generator(device=gpu).manual_seed(7)
    D, B, C = 40, 32, 10
    z = 2.0 * torch.randn(D, B, C, generator=g, device=gpu)
    y = torch.randint(0, C, (D, B), generator=g, device=gpu)
    gout = torch.softmax(torch.randn(D, C, C, generator=g, device=gpu), -1)
    betas = torch.rand(D, generator=g, device=gpu) * 0.1
    k = torch.tensor([3], device=gpu)

    def sums():
        return (torch.zeros(D, 8, device=gpu),
                torch.zeros(D, C, C, device=gpu), torch.zeros(D, C,
                                                              device=gpu))

    mine, want = sums(), sums()
    before = runtime.KERNELS["distill_step"].launches
    got = distill_step(z, y, gout, betas, k, *mine)
    ref = distill_step_plain(z, y, gout, betas, k, *want)
    torch.cuda.synchronize()
    assert runtime.KERNELS["distill_step"].launches == before + 1
    for a, b in zip([got, *mine], [ref, *want]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    one, many = sums(), sums()
    a = distill_step(z, y, gout, torch.tensor([0.02], device=gpu), k, *one)
    b = distill_step(z, y, gout, torch.full((D,), 0.02, device=gpu), k,
                     *many)
    assert torch.equal(a, b)
    for u, v in zip(one, many):
        assert torch.equal(u, v)


def test_randint_tensor_bound_on_gpu_matches_cpu(gpu):
    keys = rng.split(rng.split(rng.PRNGKey(3), 4), 8)
    bounds = torch.tensor([300, 60, 5, 151936])
    want = rng.randint(keys, (16,), 0, bounds)
    got = rng.randint(keys.to(gpu), (16,), 0, bounds.to(gpu))
    assert torch.equal(got.cpu(), want)


def test_sweep_on_gpu_matches_cpu(gpu):
    """A mix2fld grid over eta x beta x server_iters (ragged conversion,
    a beta per device row through the kernel) on the card and on the
    CPU; one local and one conversion capture on the card, every local
    step one distill_step launch."""
    from repro_torch.sweep import SweepRunner, engine_stats, make_grid

    x, y = synthetic_images(rng.PRNGKey(42), 1400, device="cpu")
    dev_x, dev_y = PartitionSpec("iid", n_local=300).build(
        x[:1200], y[:1200], 4, 10)
    fc = FederatedConfig(protocol="mix2fld", num_devices=4, local_iters=8,
                         local_batch=16, server_iters=8, server_batch=16,
                         max_rounds=3, n_seed=6, n_inverse=12, seed=0)
    grid = make_grid(fc, ChannelConfig(num_devices=4, p_up_dbm=40.0),
                     eta=(0.01, 0.02), beta=(0.005, 0.02),
                     server_iters=(6, 12))
    res = {}
    for dev in ("cpu", gpu):
        engine_stats.reset()
        before = runtime.KERNELS["distill_step"].launches
        runner = SweepRunner(CNN(), grid, dev_x, dev_y, x[1200:],
                             y[1200:], device=dev)
        res[str(dev)] = runner.run()
        if dev != "cpu":
            assert engine_stats.captures == 2
            assert runtime.KERNELS["distill_step"].launches - before == \
                3 * 8
    cpu, card = res["cpu"], res[str(gpu)]
    np.testing.assert_allclose(card.loss, cpu.loss, rtol=0, atol=1e-4)
    np.testing.assert_allclose(card.acc, cpu.acc, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(card.latency_s, cpu.latency_s)
    np.testing.assert_array_equal(card.up_ok, cpu.up_ok)
    np.testing.assert_array_equal(card.converged, cpu.converged)


# ---------------------------------------------------------------------------
# LM training (A15-train)
# ---------------------------------------------------------------------------

def test_forward_only_kernels_refuse_a_recorded_gradient(gpu):
    """flash_attention and ssd_scan have no backward: a CUDA input that
    requires grad under grad mode raises; under no_grad they launch."""
    q = torch.randn(2, 64, 32, device=gpu, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(q, q, q)
    xdt, B, C, dA = _ssd_inputs(gpu, 2, 128, 32, 16, 1, 0)
    with pytest.raises(ValueError, match="no backward"):
        ssd_scan(xdt.requires_grad_(True), B, C, dA, 32)
    with torch.no_grad():
        flash_attention(q, q, q)
        ssd_scan(xdt, B, C, dA, 32)


def _train_parity(gpu, arch):
    """One train step and one favg table of ``arch``'s smoke config on
    the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_favg_step, make_train_step
    from repro_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).smoke()
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    out = {}
    for dev in (gpu, torch.device("cpu")):
        params = init_params(cfg, rng.PRNGKey(0), device=dev)
        before = runtime.launch_counts()
        new, m = make_train_step(cfg)(params, {"tokens": toks.to(dev)})
        grad_launches = sum(runtime.launch_counts().values()) - \
            sum(before.values())
        table = make_favg_step(cfg)(new, {"tokens": toks.to(dev)})
        out[dev.type] = (new, m, table, grad_launches)
    return out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m",
                                  "zamba2-2.7b"])
def test_train_step_on_gpu_matches_cpu(gpu, arch):
    """No kernel inside the gradient step; loss and updated parameters
    within 1e-5 of the CPU's; the favg table (through the kernels on the
    card) within 1e-4."""
    from repro_torch.launch.steps import tree_leaves
    out = _train_parity(gpu, arch)
    new, m, table, launches = out["cuda"]
    assert launches == 0
    want_new, want_m, want_table, _ = out["cpu"]
    assert abs(float(m["loss"]) - float(want_m["loss"])) <= 1e-5
    for a, b in zip(tree_leaves(new), tree_leaves(want_new)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    torch.testing.assert_close(table.cpu(), want_table, rtol=0, atol=1e-4)


def test_full_width_train_step_on_gpu(gpu):
    """qwen2-0.5b at its published widths (bf16), one train step at (2,
    512): finite loss and parameters, no kernel launched in it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step, tree_leaves
    from repro_torch.models.transformer import init_params

    cfg = get_config("qwen2-0.5b")
    params = init_params(cfg, rng.PRNGKey(0), device=gpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 512), device=gpu)
    before = sum(runtime.launch_counts().values())
    new, m = make_train_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert sum(runtime.launch_counts().values()) == before
    assert torch.isfinite(m["loss"])
    for t in tree_leaves(new):
        assert t.dtype == torch.bfloat16 and torch.isfinite(t).all()


def test_transformer_classifier_run_on_gpu_matches_cpu(gpu):
    """model="transformer" for 2 rounds at a small config: the captured
    local step and conversion (no kernel) and the no-grad evaluation
    (flash attention at head dim 16) on the card, against the CPU."""
    x, y = synthetic_images(rng.PRNGKey(42), 1400, device="cpu")
    dev_x, dev_y = partition_iid(x[:1200], y[:1200], 4, 300, 10, seed=0)
    fc = dict(protocol="mix2fld", model="transformer", num_devices=4,
              local_iters=8, local_batch=16, server_iters=8, max_rounds=2,
              n_seed=6, n_inverse=12)
    hs = []
    for dev in (gpu, "cpu"):
        runtime.reset_launch_counts()
        hs.append(FederatedTrainer(
            None, FederatedConfig(**fc),
            ChannelConfig(num_devices=4, p_up_dbm=40.0),
            device=dev).run(dev_x, dev_y, x[1200:], y[1200:]))
        if dev is gpu:
            assert runtime.launch_counts()["flash_attention"] > 0
    np.testing.assert_allclose(hs[0]["loss"], hs[1]["loss"], atol=1e-4)
    np.testing.assert_allclose(hs[0]["acc"], hs[1]["acc"], atol=1e-4)
    assert hs[0]["uplink_ok"] == hs[1]["uplink_ok"]


# ---------------------------------------------------------------------------
# The sharded round loop (A13): one NCCL rank, and two gloo ranks sharing
# the card
# ---------------------------------------------------------------------------

SHARD_CFG = dict(protocol="mix2fld", num_devices=4, local_iters=8,
                 local_batch=16, server_iters=8, server_batch=16,
                 max_rounds=3, n_seed=6, n_inverse=12, seed=0)


def _shard_data():
    x, y = synthetic_images(rng.PRNGKey(42, "cpu"), 1400, device="cpu")
    dev_x, dev_y = partition_iid(x[:1200].numpy(), y[:1200].numpy(), 4,
                                 300, 10, seed=0)
    return (np.asarray(dev_x), np.asarray(dev_y), x[1200:].numpy(),
            y[1200:].numpy())


def _vmapped_deterministic(gpu, data, emulate=False):
    """The vmapped run under deterministic cuDNN; with ``emulate``, the
    2 ranks' step shape and partial sums emulated in this process
    (``emulated_shards``); the history, last tables and rounds."""
    import contextlib

    from repro_torch.device import deterministic_cudnn
    from repro_torch.launch.ranks import emulated_shards, record_rounds
    with deterministic_cudnn(gpu):
        tr = FederatedTrainer(CNN(), FederatedConfig(**SHARD_CFG),
                              ChannelConfig(num_devices=4, p_up_dbm=40.0),
                              device=gpu)
        rounds = record_rounds(tr)
        with (emulated_shards(tr, 2) if emulate else
              contextlib.nullcontext()):
            h = tr.run(*data)
    return h, tr.last_dev_gout.cpu().numpy(), rounds


def test_sharded_trainer_on_one_nccl_rank_equals_vmapped(gpu):
    """``shard_devices=True`` in a plain process starts a one-rank NCCL
    group: bit for bit the vmapped run (both under cuDNN's deterministic
    algorithms, which the sharded path uses), the kernels launched as
    there."""
    import torch.distributed as dist
    data = _shard_data()
    want, want_gout, _ = _vmapped_deterministic(gpu, data)
    started = not dist.is_initialized()
    try:
        tr = FederatedTrainer(CNN(), FederatedConfig(shard_devices=True,
                                                     **SHARD_CFG),
                              ChannelConfig(num_devices=4, p_up_dbm=40.0),
                              device=gpu)
        assert dist.get_backend() == "nccl" and tuple(tr.mesh.shape) == (1,)
        runtime.reset_launch_counts()
        got = tr.run(*data)
        counts = runtime.launch_counts()
        for k in ("acc", "loss", "round_latency_s", "uplink_ok",
                  "converged_round"):
            assert got[k] == want[k], k
        np.testing.assert_array_equal(tr.last_dev_gout.cpu().numpy(),
                                      want_gout)
        assert counts["distill_step"] == 3 * 8 and counts["mixup"] >= 1
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def test_sharded_trainer_on_two_gloo_ranks_sharing_the_card(gpu, tmp_path):
    """Two spawned ranks on cuda:0 with gloo on CUDA tensors, 2 rows a
    rank: within the reference's multichip bounds of the vmapped run,
    bit for bit the vmapped run with the ranks' step shape and partial
    sums emulated, and every rank's replicated state equal at each
    round's end."""
    from torch_ranks import spawn, trainer_runs
    data = _shard_data()
    want, want_gout, _ = _vmapped_deterministic(gpu, data)
    emu, emu_gout, emu_rounds = _vmapped_deterministic(gpu, data, True)
    outs = spawn(trainer_runs, 2, tmp_path,
                 [(SHARD_CFG, dict(num_devices=4, p_up_dbm=40.0), data)],
                 "cuda")
    for out in outs:
        got = out[0]
        assert got["mesh"] == (2,) and got["step_rows"] == [2]
        assert got["launches"]["distill_step"] == 3 * 8
        np.testing.assert_allclose(got["history"]["acc"], want["acc"],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["history"]["loss"], want["loss"],
                                   rtol=0, atol=1e-4)
        for k in ("round_latency_s", "uplink_ok", "converged_round"):
            assert got["history"][k] == want[k], k
        np.testing.assert_allclose(got["last_dev_gout"], want_gout, rtol=0,
                                   atol=1e-5)
        for k, v in got["history"].items():
            assert v == emu[k], k
        np.testing.assert_array_equal(got["last_dev_gout"], emu_gout)
        for a, b in zip(got["rounds"], emu_rounds):
            np.testing.assert_array_equal(a["g_params"], b["g_params"])
            np.testing.assert_array_equal(a["dev_gout"], b["dev_gout"])
    for a, b in zip(outs[0][0]["rounds"], outs[1][0]["rounds"]):
        np.testing.assert_array_equal(a["g_params"], b["g_params"])
        np.testing.assert_array_equal(a["dev_gout"], b["dev_gout"])
