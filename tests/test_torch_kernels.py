"""The port's kernel modules on the CPU: each plain version against the
reference's Pallas kernel (interpret mode, as the reference's own tests
run it), the ``ops`` wrappers against the reference's, the autograd
Function against gradcheck, and the dispatch rule.
The CUDA kernels themselves run only on a GPU (tests/test_torch_cuda.py
and chip_smoke.py hold them against these plain versions there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, runtime
from repro_torch.kernels.distill_loss import (distill_loss,
                                              distill_loss_plain,
                                              distill_phi_psi, phi_psi_bwd,
                                              phi_psi_bwd_plain, phi_psi_fwd,
                                              phi_psi_plain)
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention)
from repro_torch.kernels.mixup_kernel import mixup, mixup_plain
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from test_torch_reference import load_reference

# float32 on both sides: the same elementwise arithmetic, the tolerance
# covers exp/log and summation-order differences
F32_ATOL = 1e-5
# bfloat16 attention: the Pallas kernel rounds the unnormalised
# probabilities (running max) to bf16, the plain version the normalised
# ones, and both round the output: 2 bf16 ulps of |o| <= 4
BF16_ATTN_ATOL = 2 * 2.0 ** -6


@pytest.mark.parametrize("n,f", [(8, 64), (100, 784), (256, 512), (33, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixup_plain_matches_pallas(n, f, dtype):
    ref = load_reference()
    rs = np.random.default_rng(n * 1000 + f)
    a = rs.standard_normal((n, f)).astype(np.float32)
    b = rs.standard_normal((n, f)).astype(np.float32)
    la = rs.uniform(-0.2, 1.2, n).astype(np.float32)
    lb = (1.0 - la).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = ref.mixup_kernel.mixup_pallas(jnp.asarray(a, jd),
                                         jnp.asarray(b, jd),
                                         jnp.asarray(la), jnp.asarray(lb))
    got = mixup(torch.tensor(a).to(td), torch.tensor(b).to(td),
                torch.tensor(la), torch.tensor(lb))
    assert got.dtype == td
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        # XLA may contract the two products into an FMA: last-bit only
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)
    else:
        # both round one float32 result to bfloat16: at most 1 bf16 ulp
        ab = [torch.tensor(t).to(td).float().numpy() for t in (a, b)]
        exact = la[:, None] * ab[0] + lb[:, None] * ab[1]
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(exact),
                                                  1e-30))) - 7)
        assert (np.abs(got.float().numpy() - want) <= ulp).all()


def _distill_inputs(n, c, seed):
    rs = np.random.default_rng(seed)
    z = (2.0 * rs.standard_normal((n, c))).astype(np.float32)
    y = rs.integers(0, c, n)
    g = np.exp(rs.standard_normal((n, c)))
    g = (g / g.sum(-1, keepdims=True)).astype(np.float32)
    g[: n // 4] = rs.uniform(0, 1, (n // 4, c))   # unnormalised rows
    g[n // 4: n // 4 + 2] = 0.0                    # zero rows
    return z, y, g


@pytest.mark.parametrize("n,c", [(160, 10), (16, 10), (33, 12), (1000, 10)])
def test_distill_plain_matches_pallas_value_and_vjp(n, c):
    ref = load_reference()
    z, y, g = _distill_inputs(n, c, n + c)
    rs = np.random.default_rng(1)
    dphi = rs.standard_normal(n).astype(np.float32)
    dpsi = rs.standard_normal(n).astype(np.float32)
    (phi_j, psi_j), vjp = jax.vjp(
        lambda z_, g_: ref.distill_loss.distill_phi_psi(
            z_, jnp.asarray(y, jnp.int32), g_), jnp.asarray(z),
        jnp.asarray(g))
    dz_j, dg_j = vjp((jnp.asarray(dphi), jnp.asarray(dpsi)))
    zt, yt, gt = torch.tensor(z), torch.tensor(y), torch.tensor(g)
    phi, psi = phi_psi_plain(zt, yt, gt)
    dz, dg = phi_psi_bwd_plain(zt, yt, gt, torch.tensor(dphi),
                               torch.tensor(dpsi))
    for want, got in ((phi_j, phi), (psi_j, psi), (dz_j, dz), (dg_j, dg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=F32_ATOL)


def test_distill_autograd_function_backward_is_the_plain_vjp():
    z, y, g = _distill_inputs(40, 10, 3)
    zt = torch.tensor(z, requires_grad=True)
    gt = torch.tensor(g, requires_grad=True)
    yt = torch.tensor(y)
    phi, psi = distill_phi_psi(zt, yt, gt)
    (phi * 0.3 + psi * 0.7).sum().backward()
    dz, dg = phi_psi_bwd_plain(zt.detach(), yt, gt.detach(),
                               torch.full((40,), 0.3),
                               torch.full((40,), 0.7))
    torch.testing.assert_close(zt.grad, dz)
    torch.testing.assert_close(gt.grad, dg)


def test_distill_autograd_function_gradcheck_float64():
    z, y, g = _distill_inputs(12, 7, 4)
    zt = torch.tensor(z, dtype=torch.float64, requires_grad=True)
    gt = torch.tensor(g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda z_, g_: distill_phi_psi(z_, torch.tensor(y), g_), (zt, gt))


def _qkv(bh, s, d, seed):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("bh,s,d", [(4, 256, 32), (2, 256, 64)])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas(bh, s, d, window, dtype):
    """Two 128-blocks of queries and keys, so the Pallas online softmax
    crosses blocks."""
    ref = load_reference()
    q, k, v = _qkv(bh, s, d, bh * s + d)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref.flash_attention.flash_attention_pallas(
        *(jnp.asarray(t, jd) for t in (q, k, v)), window=window,
        interpret=True, blk_q=128, blk_k=128)
    got = attention_plain(*(torch.tensor(t).to(td) for t in (q, k, v)),
                          window=window)
    assert got.dtype == td and tuple(got.shape) == (bh, s, d)
    atol = F32_ATOL if dtype == "float32" else BF16_ATTN_ATOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("s,window", [(100, None), (37, 5), (1, None)])
def test_flash_wrapper_matches_attention_ref_at_any_length(s, window):
    """Prompt lengths that no Pallas block divides: the wrapper against
    the reference's attention_ref oracle."""
    ref = load_reference()
    q, k, v = _qkv(3, s, 32, s)
    want = ref.ref.attention_ref(*(jnp.asarray(t) for t in (q, k, v)),
                                 window=window)
    got = flash_attention(*(torch.tensor(t) for t in (q, k, v)),
                          window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)


@pytest.mark.parametrize("n,c", [(160, 10), (33, 12), (1000, 10)])
def test_distill_loss_plain_matches_pallas(n, c):
    ref = load_reference()
    z, y, g = _distill_inputs(n, c, n * c)
    g = np.exp(g) / np.exp(g).sum(-1, keepdims=True)   # normalised rows
    want = ref.distill_loss.distill_loss_pallas(
        jnp.asarray(z), jnp.asarray(y, jnp.int32), jnp.asarray(g), 0.01)
    got = distill_loss(torch.tensor(z), torch.tensor(y), torch.tensor(g),
                       0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(
        distill_loss_plain(torch.tensor(z), torch.tensor(y),
                           torch.tensor(g), 0.01).numpy(),
        np.asarray(ref.ref.distill_loss_ref(
            jnp.asarray(z), jnp.asarray(y), jnp.asarray(g), 0.01)),
        rtol=0, atol=F32_ATOL)


def test_ops_wrappers_match_reference_ops():
    ref = load_reference()
    rs = np.random.default_rng(11)
    a = rs.uniform(0, 1, (6, 28, 28, 1)).astype(np.float32)
    b = rs.uniform(0, 1, (6, 28, 28, 1)).astype(np.float32)
    np.testing.assert_allclose(
        ops.mixup(torch.tensor(a), torch.tensor(b), 0.1).numpy(),
        np.asarray(ref.ops.mixup(jnp.asarray(a), jnp.asarray(b), 0.1)),
        rtol=0, atol=F32_ATOL)
    for got, want in zip(
            ops.inverse_mixup_pair(torch.tensor(a), torch.tensor(b), 0.1),
            ref.ops.inverse_mixup_pair(jnp.asarray(a), jnp.asarray(b),
                                       0.1)):
        assert tuple(got.shape) == a.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F32_ATOL)
    z, y, _ = _distill_inputs(64, 10, 2)
    gout = rs.uniform(0, 1, (10, 10))
    gout = (gout / gout.sum(-1, keepdims=True)).astype(np.float32)
    got = ops.distill_loss(torch.tensor(z), torch.tensor(y, dtype=torch.int32),
                           torch.tensor(gout), 0.01)
    want = ref.ops.distill_loss(jnp.asarray(z), jnp.asarray(y, jnp.int32),
                                jnp.asarray(gout), 0.01)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=0,
                               atol=F32_ATOL)
    q, k, v = _qkv(2, 256, 32, 5)
    np.testing.assert_allclose(
        ops.flash_attention(*(torch.tensor(t) for t in (q, k, v)),
                            window=32).numpy(),
        np.asarray(ref.ops.flash_attention(
            *(jnp.asarray(t) for t in (q, k, v)), window=32)),
        rtol=0, atol=F32_ATOL)
    # the SSD scan: per-head B/C, chunk min(64, S), y only; the
    # reference's kernel tolerance
    rs = np.random.default_rng(9)
    for s in (128, 48):
        xdt, B, C = (0.5 * rs.standard_normal((3, s, d)).astype(np.float32)
                     for d in (32, 16, 16))
        dA = -np.log1p(np.exp(rs.standard_normal((3, s)))).astype(np.float32)
        got = ops.ssd_scan(*(torch.tensor(t) for t in (xdt, B, C, dA)))
        want = ref.ops.ssd_scan(*(jnp.asarray(t) for t in (xdt, B, C, dA)))
        assert tuple(got.shape) == (3, s, 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-4, rtol=1e-3)


def test_distill_loss_refuses_gradients():
    z, y, g = (torch.tensor(t) for t in _distill_inputs(8, 5, 0))
    with pytest.raises(RuntimeError, match="forward only"):
        distill_loss(z.requires_grad_(), y, g, 0.01)
    with torch.no_grad():
        assert distill_loss(z, y, g, 0.01).shape == (8,)


def test_cpu_tensors_take_the_plain_versions():
    runtime.reset_launch_counts()
    a = torch.rand(5, 7)
    la = torch.rand(5)
    torch.testing.assert_close(mixup(a, a, la, 1 - la),
                               mixup_plain(a, a, la, 1 - la))
    z, y, g = (torch.tensor(t) for t in _distill_inputs(8, 5, 0))
    torch.testing.assert_close(phi_psi_fwd(z, y, g), phi_psi_plain(z, y, g))
    d = torch.ones(8)
    torch.testing.assert_close(phi_psi_bwd(z, y, g, d, d),
                               phi_psi_bwd_plain(z, y, g, d, d))
    torch.testing.assert_close(distill_loss(z, y, g, 0.5),
                               distill_loss_plain(z, y, g, 0.5))
    q = torch.rand(2, 9, 32)
    torch.testing.assert_close(flash_attention(q, q, q, window=3),
                               attention_plain(q, q, q, window=3))
    x, dA = torch.rand(4, 64, 8), -torch.rand(4, 64)
    b = torch.rand(2, 64, 4)
    y, st = ssd_scan(x, b, b, dA, 16, final=True, heads_per_group=2)
    want = ssd_scan_plain(x, b, b, dA, 16, heads_per_group=2)
    torch.testing.assert_close((y, st), want)
    assert set(runtime.launch_counts().values()) == {0}


def test_wrappers_reject_bad_arguments():
    a = torch.rand(5, 7)
    with pytest.raises(ValueError):
        mixup(a, torch.rand(5, 6), torch.rand(5), torch.rand(5))
    with pytest.raises(ValueError):
        mixup(a, a, torch.rand(4), torch.rand(4))
    with pytest.raises(ValueError):
        runtime.on_cuda(a, torch.rand(3, device="meta"))
    with pytest.raises(ValueError):
        runtime.on_cuda(torch.rand(3, device="meta"))
    q = torch.rand(2, 9, 32)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :8], q)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, window=0)
    x, dA, b = torch.rand(4, 64, 8), -torch.rand(4, 64), torch.rand(4, 64, 4)
    with pytest.raises(ValueError):
        ssd_scan(x, b, b, dA, 48)                  # S % chunk
    with pytest.raises(ValueError):
        ssd_scan(x, b[:, :32], b[:, :32], dA, 16)  # S of B differs
    with pytest.raises(ValueError):
        ssd_scan(x, b, b, dA, 16, heads_per_group=3)
    with pytest.raises(ValueError):
        ssd_scan(x, b, b, dA, 16, initial_state=torch.zeros(4, 8, 4))


def test_every_kernel_is_registered_with_a_source():
    names = set(runtime.KERNELS)
    assert names == {"mixup", "distill_fwd", "distill_bwd", "distill_loss",
                     "distill_step", "flash_attention", "ssd_scan"}
    for k in runtime.KERNELS.values():
        assert (runtime.SRC_DIR / k.source).is_file()


def test_library_key_covers_every_header(tmp_path, monkeypatch):
    """A library is keyed by its source, every header of csrc/ and the
    flags: an edited shared header (hopper.cuh) rebuilds the libraries
    that include it instead of loading a stale one."""
    for f in runtime.SRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(runtime, "SRC_DIR", tmp_path)
    sources = ("ssd_scan.cu", "flash_attention.cu", "mixup.cu")
    keys = {src: runtime._target(src) for src in sources}
    assert len(set(keys.values())) == len(sources)
    assert {src: runtime._target(src) for src in sources} == keys
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert all(runtime._target(src) != keys[src] for src in sources)
    edited = {src: runtime._target(src) for src in sources}
    (tmp_path / "mixup.cu").write_text(
        (tmp_path / "mixup.cu").read_text() + "\n// edited\n")
    assert runtime._target("mixup.cu") != edited["mixup.cu"]
    assert runtime._target("ssd_scan.cu") == edited["ssd_scan.cu"]
