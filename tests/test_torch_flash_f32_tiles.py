"""The float32 flash kernel's algorithm, emulated on the CPU.

``csrc/flash_attention.cu`` runs float32 attention on the tensor cores in
3xTF32: a TF32 operand keeps the top 10 mantissa bits (the tensor core
drops the low 13), so each operand a is split into trunc(a) and
a - trunc(a), and rest(a).trunc(b) + trunc(a).rest(b) + trunc(a).trunc(b)
are summed in float32, for S = Q K^T and for P V alike.  A warpgroup
takes 64 query rows and walks their key tiles (64 keys, or 32 where
shared memory is short and for the narrow heads) with an online softmax:
p = exp(s - m) from the running max m (exp2, scale * log2(e) folded in),
l summed from the unrounded p, the output divided by max(l, 1e-30).  V
is transposed in shared memory into V^T with the keys of each group of 8
in the order 0 2 4 6 1 3 5 7, so that P's TF32 A fragments are the score
accumulator's own registers.

The card tests (``tests/test_torch_cuda.py``) hold the kernel to
``attention_plain`` at 2e-5 (``F32_ATTN_ATOL`` in ``chip_smoke.py``).
Here an emulation of that algorithm, written in this file and not in the
package, meets the same tolerance against ``attention_plain`` and against
the reference's Pallas kernel (interpret mode) at the card tests' float32
shapes, with and without a window; one TF32 product per operand pair
misses it, which is why the kernel pays for three; and the fragment
orders of the kernel's source pair every key of P with its row of V^T.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import attention_plain
from test_torch_reference import load_reference

BQ = 64                  # the kernel's query tile: one warpgroup's rows
ATOL = 2e-5              # F32_ATTN_ATOL, tests/test_torch_cuda.py
ROOM = 232448 - 2 * 1024  # csrc/flash_attention.cu f32::Layout::ROOM
# tests/test_torch_cuda.py's float32 cases: (bh, s, d, dv, window)
CARD = [
    (8, 100, 64, 64, None),
    (8, 256, 32, 32, None),
    (4, 300, 128, 128, 7),
    (2, 1, 32, 32, None),
    (8, 160, 80, 80, 128),
    (4, 300, 80, 80, 7),
    (2000, 16, 16, 16, None),   # the transformer classifier's evaluation
    (4, 300, 16, 16, 7),
    (8, 64, 96, 96, None),
    (8, 300, 96, 96, 7),
    (8, 160, 120, 120, 128),
    (8, 300, 120, 120, None),
    (8, 40, 48, 32, None),      # MLA: the deepseek-v2 smoke config
    (8, 300, 48, 32, 7),
    (8, 160, 192, 128, None),   # its width-192 variant
    (4, 300, 192, 128, 128),
]


def pad32(x):
    return -(-x // 32) * 32


def key_tile(d, dv, bufs=1):
    """The kernel's key tile at (d, dv) (f32::Layout::BK): 32 keys for the
    narrow heads (d, dv <= 32); else 64 where two K/V stages fit beside Q
    (big and small) and ``bufs`` buffers of K's small part and V^T (big
    and small), else 32.  bufs: 1 for the one-warpgroup kernel, 2 for the
    one with a splitter warpgroup."""
    dp, dvp = pad32(d), pad32(dv)
    if dp + dvp <= 64:
        return 32
    fixed = 2 * BQ * dp * 4 + bufs * (64 * dp * 4 + 2 * dvp * 64 * 4)
    return 64 if fixed + 2 * bk_stage(64, dp, dvp) <= ROOM else 32


def bk_stage(bk, dp, dvp):
    return bk * (dp + dvp) * 4


def trunc(a):
    """a as the tensor core reads it in TF32: the low 13 mantissa bits
    dropped."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm(a, b, passes):
    """a @ b on TF32 operands with float32 sums: one product, or 3xTF32 in
    the kernel's order (small.big, big.small, big.big)."""
    if passes == 1:
        return trunc(a) @ trunc(b)
    ab, bb = trunc(a), trunc(b)
    return trunc(a - ab) @ bb + ab @ trunc(b - bb) + ab @ bb


def vt_order(bk):
    """The key each position of V^T holds: 0 2 4 6 1 3 5 7 in every 8."""
    return torch.tensor([8 * g + o for g in range(bk // 8)
                         for o in (0, 2, 4, 6, 1, 3, 5, 7)])


def emulate(q, k, v, window=None, passes=3):
    """q, k: (BH, S, d), v: (BH, S, dv), float32 -> (BH, S, dv), by the
    kernel's tiles, online softmax and 3xTF32 products (K and V padded
    with zero keys to whole tiles, as TMA fills them)."""
    bh, s, d = q.shape
    dv = v.shape[-1]
    bk = key_tile(d, dv)
    n_k = -(-s // bk) * bk
    kf = torch.nn.functional.pad(k, (0, 0, 0, n_k - s))
    vf = torch.nn.functional.pad(v, (0, 0, 0, n_k - s))
    c = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    order = vt_order(bk)
    out = torch.empty(bh, s, dv)
    for q0 in range(0, s, BQ):
        rows = torch.arange(q0, min(q0 + BQ, s))
        m = torch.full((bh, len(rows)), -1e30)
        l = torch.zeros(bh, len(rows))
        acc = torch.zeros(bh, len(rows), dv)
        first = max(0, q0 - window + 1) // bk if window else 0
        for t in range(first, int(rows[-1]) // bk + 1):
            keys = torch.arange(t * bk, t * bk + bk)
            sc = mm(q[:, rows], kf[:, keys].transpose(-1, -2), passes)
            keep = (keys[None, :] <= rows[:, None]) & (keys[None, :] < s)
            if window:
                keep &= rows[:, None] - keys[None, :] < window
            sc = torch.where(keep, sc, -math.inf)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2(sc * c - (m_new * c)[..., None])
            l = l * alpha + p.sum(-1)
            # P's columns and V^T's keys in the kernel's k order
            pv = mm(p[..., order], vf[:, keys[order]], passes)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out


def _inputs(bh, s, d, dv, seed):
    rs = np.random.default_rng(seed)
    q, k = (rs.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(2))
    return q, k, rs.standard_normal((bh, s, dv)).astype(np.float32)


@pytest.mark.parametrize("bh,s,d,dv,window", CARD)
def test_emulation_matches_attention_plain(bh, s, d, dv, window):
    q, k, v = (torch.tensor(x) for x in _inputs(bh, s, d, dv, s + d))
    got = emulate(q, k, v, window)
    want = attention_plain(q, k, v, window)
    assert got.shape == (bh, s, dv)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("bh,s,d,dv,window", CARD)
def test_emulation_matches_pallas(bh, s, d, dv, window):
    """The reference's kernel with one block a row (its blocks must divide
    S), in interpret mode."""
    ref = load_reference()
    x = _inputs(bh, s, d, dv, s + dv)
    want = ref.flash_attention.flash_attention_pallas(
        *(jnp.asarray(t) for t in x), window=window, interpret=True,
        blk_q=s, blk_k=s)
    got = emulate(*(torch.tensor(t) for t in x), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("bh,s,d,dv", [(32, 128, 64, 64),
                                       (8, 160, 192, 128)])
def test_single_pass_tf32_misses_the_tolerance(bh, s, d, dv):
    """At the 25m preset's favg call and MLA's width-192 smoke call, one
    TF32 product per operand pair is many times outside the tolerance
    that 3xTF32 meets with room."""
    q, k, v = (torch.tensor(x) for x in _inputs(bh, s, d, dv, d))
    want = attention_plain(q, k, v)
    one = float((emulate(q, k, v, passes=1) - want).abs().max())
    three = float((emulate(q, k, v, passes=3) - want).abs().max())
    assert one > 5 * ATOL, one
    assert three < ATOL / 4, three


@pytest.mark.parametrize("bk", [32, 64])
def test_fragment_orders_pair_p_with_v_transposed(bk):
    """The source's indices, lane by lane: the score accumulator holds
    element 4j + 2h + c at (row g + 8h, key 8j + 2t + c); issue_pv hands
    the TF32 A fragment {sc[4j], sc[4j + 2], sc[4j + 1], sc[4j + 3]},
    whose registers are (row g, k t), (g + 8, t), (g, t + 4), (g + 8,
    t + 4); transpose_split writes key 8 (grp / 2) + (grp % 2) + 2i at
    k position 4 grp + i.  Every k position of every k-step then meets
    the key its V^T row holds, and each key once."""
    vt_key = {}
    for grp in range(bk // 4):
        key0 = 8 * (grp >> 1) + (grp & 1)
        for i in range(4):
            vt_key[4 * grp + i] = key0 + 2 * i
    assert sorted(vt_key.values()) == list(range(bk))
    assert [vt_key[i] for i in range(bk)] == vt_order(bk).tolist()
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(bk // 8):
            acc = {4 * j + 2 * h + c: (g + 8 * h, 8 * j + 2 * t + c)
                   for h in range(2) for c in range(2)}
            frag = [acc[4 * j], acc[4 * j + 2], acc[4 * j + 1],
                    acc[4 * j + 3]]
            slots = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
            for (row, key), (a_row, a_k) in zip(frag, slots):
                assert row == a_row
                assert vt_key[8 * j + a_k] == key


@pytest.mark.parametrize("d,dv,bk", [(16, 16, 32), (32, 32, 32),
                                     (48, 32, 64), (64, 64, 64),
                                     (96, 96, 64), (128, 64, 64),
                                     (128, 128, 32), (80, 128, 32),
                                     (192, 128, 32)])
def test_key_tiles(d, dv, bk):
    """64 keys where two K/V stages fit; the narrow heads, MLA's (192,
    128) and d 128 with dv 128 take 32, and (192, 128) has room for one
    stage only.  The split kernel (d, dv <= 64, two buffers) takes the
    same tiles."""
    assert key_tile(d, dv) == bk
    if d <= 64 and dv <= 64:
        assert key_tile(d, dv, bufs=2) == bk
    dp, dvp = pad32(d), pad32(dv)
    fixed = 2 * BQ * dp * 4 + bk * dp * 4 + 2 * dvp * bk * 4
    stages = (ROOM - fixed) // bk_stage(bk, dp, dvp)
    assert stages >= (1 if (d, dv) == (192, 128) else 2), stages
