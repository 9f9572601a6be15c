"""The port's CUDA kernels on the GPU, against their plain versions.

Marked ``cuda``: they skip where no GPU exists.  On a GPU machine (which
need not have jax):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.channel import ChannelConfig
from repro_torch.core.graphs import StepGraph
from repro_torch.core.protocols import (FederatedConfig, FederatedTrainer,
                                        make_local_train)
from repro_torch.data import partition_iid, synthetic_images
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


@pytest.mark.parametrize("n,f", [(7, 3), (9, 5), (5, 1023), (100, 784)])
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
# and without KD, the CPU tests' (4, 16, 10), an odd (3, 5, 12), and zero
# and unnormalised G_out rows
@pytest.mark.parametrize("D,B,C,beta,odd_rows", [
    (10, 16, 10, 0.0, False), (10, 16, 10, 0.01, False),
    (4, 16, 10, 0.01, False), (3, 5, 12, 0.01, False),
    (10, 16, 10, 0.01, True)])
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
