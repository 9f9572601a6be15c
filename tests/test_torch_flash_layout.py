"""B4's entry point in the models' layout, ``flash_attention_heads``, on
the CPU: q (B, T, H, d), K/V at their own kv heads, MLA's rope key shared
by every head, the output (B, T, H, dv).

* Its plain version against the reference's grouped ``masked_attention``
  run live (query head h reads kv head h // G there too): GQA groups 1,
  2, 7 and 8, head dims 64, 80, 120 and 128, windows, and MLA's shared
  key at (dk, rp, dv) = (32, 16, 32) and (128, 64, 128); float32 within
  1e-5 and bfloat16 within 2 bf16 ulps of the output's scale, the
  tolerances of the prefill parity tests (``test_torch_lm.py``,
  ``test_torch_mla.py``).
* Bit for bit ``attention_plain`` on K/V repeated to every query head and
  the heads flattened into the batch (what the caller did before).
* Every refusal of a launch (``tma_strides``, on metadata alone): heads
  not a multiple of the kv heads, strides TMA cannot take, an unbuilt
  (d, dv), a shared key off a chunk, a misaligned base, an input that
  requires grad.
* ``gqa_attention`` and ``mla_attention`` without a gradient (the serve's
  prefill, through ``prefill_attention``) against the reference's.
* The meta (dry run) and DTensor paths: the output's shape and which
  heads each rank keeps, in a fake world of 4 ranks in a process of its
  own.

The card tests (``tests/test_torch_cuda.py``) hold the kernel bit for
bit to the (BH, S, d) entry point on repeated operands.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention, transformer
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
F32_ATOL = 1e-5


def _bf16_atol(want) -> float:
    return 2 * 2.0 ** -8 * float(np.abs(want).max())


def _operands(seed, B, T, H, Hkv, d, dv, rp=0):
    """q (B, T, H, d), k (B, T, Hkv, d - rp), v (B, T, Hkv, dv) and, with
    rp, the shared key (B, T, rp), as numpy float32."""
    rs = np.random.default_rng(seed)
    shapes = [(B, T, H, d), (B, T, Hkv, d - rp), (B, T, Hkv, dv)]
    out = [rs.standard_normal(s).astype(np.float32) for s in shapes]
    return out + ([rs.standard_normal((B, T, rp)).astype(np.float32)]
                  if rp else [None])


def _reference(q, k, v, ks, window, dtype):
    """The reference's masked_attention on the same operands, the shared
    key appended to every head's K (the reference's MLA does so)."""
    ref = load_reference()
    if ks is not None:
        k = np.concatenate([k, np.broadcast_to(
            ks[:, :, None], k.shape[:3] + ks.shape[-1:])], -1)
    B, T, _, d = q.shape
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    jdt = jnp.dtype(dtype)
    out = ref.attention.masked_attention(
        *(jnp.asarray(t, jdt) for t in (q, k, v)), pos, pos,
        scale=1.0 / np.sqrt(d), window=window, causal=True)
    return np.asarray(out, np.float32)


def _heads(q, k, v, ks, window, dtype):
    tdt = getattr(torch, dtype)
    got = fa.flash_attention_heads(
        *(torch.tensor(t).to(tdt) for t in (q, k, v)), window=window,
        k_shared=None if ks is None else torch.tensor(ks).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == q.shape[:3] + v.shape[-1:]
    return got.float().numpy()


# (G, d, window): every group size, every head dim, windows among them
GQA_CASES = [(1, 64, None), (2, 80, None), (7, 120, 5), (8, 128, None),
             (2, 64, 7), (8, 80, 16), (1, 128, 3), (7, 64, None)]


@pytest.mark.parametrize("G,d,window", GQA_CASES)
def test_heads_plain_matches_reference_masked_attention(G, d, window):
    q, k, v, _ = _operands(G * d, 2, 24, 2 * G, 2, d, d)
    want = _reference(q, k, v, None, window, "float32")
    np.testing.assert_allclose(_heads(q, k, v, None, window, "float32"),
                               want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("G,d,window", [(8, 128, None), (7, 120, 5)])
def test_heads_plain_matches_reference_in_bf16(G, d, window):
    q, k, v, _ = _operands(G + d, 2, 24, 2 * G, 2, d, d)
    want = _reference(q, k, v, None, window, "bfloat16")
    np.testing.assert_allclose(_heads(q, k, v, None, window, "bfloat16"),
                               want, rtol=0, atol=_bf16_atol(want))


@pytest.mark.parametrize("dk,rp,dv", [(32, 16, 32), (128, 64, 128)])
@pytest.mark.parametrize("window", [None, 6])
def test_shared_key_matches_reference_masked_attention(dk, rp, dv, window):
    """MLA's layout: every head's K is its own dk columns and the one rope
    key; the scale is that of dk + rp."""
    q, k, v, ks = _operands(dk + rp, 2, 24, 4, 4, dk + rp, dv, rp)
    want = _reference(q, k, v, ks, window, "float32")
    np.testing.assert_allclose(_heads(q, k, v, ks, window, "float32"),
                               want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("G,rp,window", [(1, 0, None), (4, 0, 9),
                                         (7, 0, None), (1, 16, None),
                                         (2, 32, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heads_plain_is_attention_plain_on_repeated_operands(G, rp, window,
                                                             dtype):
    """Bit for bit the (BH, S, d) plain version on what the caller built
    before: K (with the shared key appended) and V repeated to every
    query head, the heads flattened into the batch."""
    B, T, Hkv, d, dv = 2, 33, 2, 64, 32
    q, k, v, ks = (None if t is None else torch.tensor(t).to(dtype)
                   for t in _operands(G, B, T, G * Hkv, Hkv, d, dv, rp))
    got = fa.attention_heads_plain(q, k, v, window, ks)
    if ks is not None:
        k = torch.cat([k, ks[:, :, None].expand(B, T, Hkv, rp)], -1)

    def flat(t):
        return t.permute(0, 2, 1, 3).reshape(-1, T, t.shape[-1])

    want = fa.attention_plain(flat(q), flat(k.repeat_interleave(G, 2)),
                              flat(v.repeat_interleave(G, 2)), window)
    assert torch.equal(got, want.reshape(B, G * Hkv, T, dv)
                       .permute(0, 2, 1, 3))


def _bf16(*shape):
    return torch.randn(*shape).bfloat16()


def test_heads_not_a_multiple_of_kv_heads_are_refused():
    q, v = _bf16(2, 16, 6, 64), _bf16(2, 16, 4, 64)
    with pytest.raises(ValueError, match="not a multiple"):
        fa.flash_attention_heads(q, v, v)
    with pytest.raises(ValueError, match="do not make"):
        fa.flash_attention_heads(_bf16(2, 16, 4, 64), v, v,
                                 k_shared=_bf16(2, 16, 16))


def test_launch_takes_the_models_layout_and_views():
    """What the serves pass: projections as they come, q a view of MLA's
    projection (head stride 192 columns, 128 read), the rope key a view
    of (B, T, 1, 64); their strides in elements, the output's after."""
    B, T, H = 2, 16, 4
    q = _bf16(B, T, H, 128)
    k = _bf16(B, T, 2, 128)
    assert fa.tma_strides(q, k, k) == [512, 128, 8192, 256, 128, 4096,
                                       256, 128, 4096, 8, 8, 8,
                                       512, 128, 8192]
    proj = _bf16(B, T, H * 192).reshape(B, T, H, 192)
    rope = _bf16(B, T, 1, 64)[:, :, 0]
    st = fa.tma_strides(proj, proj[..., :128], _bf16(B, T, H, 128), rope)
    assert st[:6] == [768, 192, 12288] * 2 and st[9:12] == [64, 8, 1024]
    # the (BH, S, d) case: one head, its stride never read
    flat = _bf16(8, T, 1, 64)
    assert fa.tma_strides(flat, flat, flat)[:3] == [64, 8, 1024]


@pytest.mark.parametrize("case", ["stride", "expanded", "transposed",
                                  "unbuilt", "shared_off_chunk",
                                  "misaligned", "grad", "dtype"])
def test_launch_refusals(case):
    """Each operand the kernel cannot take raises ValueError on its
    metadata, before any launch (the card test checks that no launch is
    counted)."""
    B, T, H = 2, 16, 4
    q, k, v, ks = (_bf16(B, T, H, 128), _bf16(B, T, 2, 128),
                   _bf16(B, T, 2, 128), None)
    if case == "stride":        # heads 65 columns apart: 130 bytes
        q = _bf16(B, T, H, 65)[..., :64]
        k = v = _bf16(B, T, 2, 64)
    elif case == "expanded":    # a kv head repeated by a 0 stride
        k = _bf16(B, T, 1, 128).expand(B, T, 2, 128)
    elif case == "transposed":  # not unit-stride in the head dim
        q = _bf16(B, T, 128, H).transpose(2, 3)
    elif case == "unbuilt":
        q = k = v = _bf16(B, T, H, 48)
    elif case == "shared_off_chunk":   # d 96 = 48 + 48
        q, k, v, ks = (_bf16(B, T, H, 96), _bf16(B, T, H, 48),
                       _bf16(B, T, H, 96), _bf16(B, T, 48))
    elif case == "misaligned":  # 2 bytes off a 16-byte boundary
        q = _bf16(B * T * H * 128 + 1)[1:].view(B, T, H, 128)
    elif case == "grad":
        q = q.requires_grad_(True)
    elif case == "dtype":
        q = q.half()
    with pytest.raises(ValueError):
        fa.tma_strides(q, k, v, ks)


def test_meta_operands_take_the_output_shape():
    """The dry run's meta tensors: the (B, T, H, dv) output, nothing
    computed."""
    q = torch.empty(2, 4096, 32, 192, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 4096, 32, 128, device="meta", dtype=torch.bfloat16)
    ks = torch.empty(2, 4096, 64, device="meta", dtype=torch.bfloat16)
    o = fa.flash_attention_heads(q, k, k, k_shared=ks)
    assert o.is_meta and tuple(o.shape) == (2, 4096, 32, 128)
    o = fa.flash_attention_heads(q[..., :128], k[:, :, :8], k[:, :, :8],
                                 window=512)
    assert o.is_meta and tuple(o.shape) == (2, 4096, 32, 128)


def _smoke(name, **kw):
    return dataclasses.replace(configs.get_config(name).smoke(), **kw)


def _ref_cfg(cfg):
    return load_reference().configs.ArchConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("arch,H,Hkv,window", [
    ("qwen2-0.5b", 8, 1, None), ("h2o-danube-3-4b", 4, 2, 8),
    ("qwen3-14b", 7, 1, None)])
def test_gqa_prefill_without_grad_matches_reference(arch, H, Hkv, window):
    """A layer's prefill under no_grad (the serve's path, through
    ``prefill_attention``) at groups of 8, 2 (windowed) and 7 (qk-norm):
    the output and the cache within 1e-5 of the reference's."""
    ref = load_reference()
    cfg = _smoke(arch, num_heads=H, num_kv_heads=Hkv,
                 sliding_window=window)
    rcfg = _ref_cfg(cfg)
    pj = jax.tree.map(np.asarray, ref.attention.init_attn(
        rcfg, jax.random.PRNGKey(H)))
    pt = transformer.params_from_jax(None, pj, "cpu")
    T = 24
    x = np.random.default_rng(H).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (2, T)).astype(np.int32)
    shape = (2, T, Hkv, cfg.head_dim)
    oj, cj = ref.attention.gqa_attention(
        rcfg, pj, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(pos),
        {"k": jnp.zeros(shape), "v": jnp.zeros(shape)})
    with torch.no_grad():
        ot, ct = attention.gqa_attention(
            cfg, pt, torch.tensor(x), torch.tensor(pos), torch.tensor(pos),
            {"k": torch.zeros(shape), "v": torch.zeros(shape)})
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=F32_ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_without_grad_matches_reference(dtype):
    """deepseek-v2's smoke layer, prompt 24 into a 32-slot latent cache,
    under no_grad: q's rope columns rotated in its own buffer and the one
    rope key shared by the kernel's heads; the output within the MLA
    parity test's tolerances, the latent cache equal in float32."""
    ref = load_reference()
    cfg = _smoke("deepseek-v2-236b", param_dtype=dtype)
    rcfg = _ref_cfg(cfg)
    pj = jax.tree.map(np.asarray, ref.attention.init_attn(
        rcfg, jax.random.PRNGKey(3)))
    pt = transformer.params_from_jax(None, pj, "cpu")
    B, T, S = 2, 24, 32
    x = np.random.default_rng(3).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    lat = {"ckv": (B, S, cfg.kv_lora_rank), "kr": (B, S, cfg.rope_head_dim)}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    oj, cj = ref.attention.mla_attention(
        rcfg, jax.tree.map(jnp.asarray, pj), jnp.asarray(x, jdt),
        jnp.asarray(pos), jnp.asarray(pos),
        {k: jnp.zeros(s, jdt) for k, s in lat.items()})
    with torch.no_grad():
        ot, ct = attention.mla_attention(
            cfg, pt, torch.tensor(x).to(tdt), torch.tensor(pos),
            torch.tensor(pos), {k: torch.zeros(s, dtype=tdt)
                                for k, s in lat.items()})
    oj = np.asarray(oj, np.float32)
    atol = F32_ATOL if dtype == "float32" else _bf16_atol(oj)
    np.testing.assert_allclose(ot.float().numpy(), oj, rtol=0, atol=atol)
    if dtype == "float32":
        for name in lat:
            np.testing.assert_allclose(ct[name].numpy(),
                                       np.asarray(cj[name]), rtol=0,
                                       atol=F32_ATOL)


def test_dtensor_operands_keep_their_batch_rows_and_kv_heads():
    """In a fake world of 4 ranks on a (2, 2) ("data", "model") mesh:
    q, k and v with their batch rows over "data" and heads over "model"
    keep both (each rank's 4 query heads read its one kv head); k at 2
    kv heads whole while q's 4 are split gives a whole head dim; MLA's
    shared key follows the batch rows.  The output is (B, T, H, dv)."""
    code = """
        import json, torch
        import torch.distributed as dist
        from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.kernels.flash_attention import flash_attention_heads
        dryrun.start_fake_world(4)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")

        def dt(shape, *place):
            return DTensor.from_local(
                torch.empty(shape, device="meta", dtype=torch.bfloat16),
                mesh, place, run_check=False)

        def placed(o):
            return [tuple(o.shape), [str(p) for p in o.placements],
                    tuple(o.to_local().shape)]

        s0, s2, r = Shard(0), Shard(2), Replicate()
        out = {}
        out["split"] = placed(flash_attention_heads(
            dt((1, 64, 4, 128), s0, s2), dt((1, 64, 1, 128), s0, s2),
            dt((1, 64, 1, 128), s0, s2)))
        out["kv_whole"] = placed(flash_attention_heads(
            dt((1, 64, 4, 128), s0, s2), dt((1, 64, 2, 128), s0, r),
            dt((1, 64, 2, 128), s0, r)))
        out["shared"] = placed(flash_attention_heads(
            dt((1, 64, 4, 192), s0, s2), dt((1, 64, 4, 128), s0, s2),
            dt((1, 64, 4, 128), s0, s2), k_shared=dt((1, 64, 64), s0, r)))
        print(json.dumps(out))
        """
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["split"] == [[2, 64, 8, 128], ["S(0)", "S(2)"],
                            [1, 64, 4, 128]]
    assert got["kv_whole"] == [[2, 64, 8, 128], ["S(0)", "R"],
                               [1, 64, 8, 128]]
    assert got["shared"] == [[2, 64, 8, 128], ["S(0)", "S(2)"],
                             [1, 64, 4, 128]]
