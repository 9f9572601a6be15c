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
from repro_torch.kernels.flash_attention import (attention_plain,
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
# version the normalised ones, both round the output: 2 bf16 ulps, |o|<=4
@pytest.mark.parametrize("bh,s,d,dtype,window,atol", [
    (56, 1024, 64, torch.bfloat16, None, 2 * 2.0 ** -6),  # serve prefill
    (8, 100, 64, torch.float32, None, 2e-5),              # ragged tail
    (8, 512, 64, torch.bfloat16, 128, 2 * 2.0 ** -6),     # sliding window
    (8, 256, 32, torch.float32, None, 2e-5),
    (4, 300, 128, torch.float32, 7, 2e-5),
    (2, 1, 32, torch.float32, None, 2e-5),
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
    torch.testing.assert_close(got.float(),
                               attention_plain(q, k, v, window).float(),
                               rtol=0, atol=atol)


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
    torch.testing.assert_close(got.float(),
                               attention_plain(q, k, v, window).float(),
                               rtol=0, atol=2 * 2.0 ** -6)


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
            (xdt, B.transpose(0, 1).contiguous().transpose(0, 1), C, dA,
             32),                                     # not contiguous
            (xdt.repeat(1, 4, 1), B.repeat(1, 4, 1), C.repeat(1, 4, 1),
             dA.repeat(1, 4), 512)):                  # chunk > 256
        with pytest.raises(ValueError):
            ssd_scan(*args)
    with pytest.raises(ValueError):
        ssd_scan(xdt, B, C, dA.cpu(), 32)


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
