"""The bfloat16 flash kernel's tiling, emulated in float32 on the CPU.

``csrc/flash_attention.cu`` (the bfloat16, tensor-core route) walks each
row's keys in tiles of 128 with an online softmax: p = exp(s - m) from
the running max m (as exp2 with scale * log2(e) folded in), l summed from
the unrounded exponentials, p rounded to bfloat16 before p.V, and the
output divided by max(l, 1e-30).  The card test
(``tests/test_torch_cuda.py``) holds the kernel to ``attention_plain`` at
2 * 2**-6.  Here an emulation of that algorithm, written in this file and
not in the package, meets the same tolerance against ``attention_plain``
and against the reference's Pallas kernel (interpret mode, 128-blocks),
which shows where no card is that the tolerance is the algorithm's own.
It also meets the per-element bound ``bf16_excess`` <= 1 that the card
tests add, and a planted fault in the window's first key tile does not.
Head dims 80, 96 and 120 run in the kernel's 128-column tile, their
columns d-127 loaded as zeros and the output's dropped, with the scale
of d; the emulation pads the same way.  MLA's (d, dv) = (192, 128)
(deepseek-v2) runs in three 64-column chunks of q and k, no padding; it
is emulated at the serve's row length of 1024.

The kernel runs one schedule at every (d, dv): it issues P_{i-1} V_{i-1}
with S_i = Q K_i^T and runs the softmax of tile i while that product is
on the tensor cores, so P_{i-1} V_{i-1} is added after the softmax of
tile i and before the rescale by alpha_i.  The emulation has that order
("overlapped") beside the textbook one ("serial": rescale, then add
P_i V_i), and the two give the same float32 output bit for bit: the
overlap changes when a product is issued, not what is summed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_plain,
                                                 bf16_excess)
from test_torch_reference import load_reference

BQ = BK = 128           # the kernel's query and key tiles
ATOL = 2 * 2.0 ** -6    # tests/test_torch_cuda.py, the bfloat16 cases
TILE = {32: 32, 64: 64, 80: 128, 96: 128, 120: 128,
        128: 128, 192: 192}   # head dim -> tile columns


def emulate(q, k, v, window=None, late_skip=0, order="overlapped"):
    """q, k: (BH, S, d), v: (BH, S, dv), bfloat16 -> (BH, S, dv) bfloat16,
    by the kernel's tiles and online softmax, in float32, with q, k and v
    zero-padded to the tile's columns.  ``late_skip`` plants a fault: the
    query tiles at or past the window start that many key tiles late
    (t_first + late_skip)."""
    return emulate_f32(q, k, v, window, late_skip, order).bfloat16()


def emulate_f32(q, k, v, window=None, late_skip=0, order="overlapped"):
    """:func:`emulate` before the output is rounded to bfloat16.  order:
    "serial" adds P_i V_i right after the rescale by alpha_i;
    "overlapped" adds P_{i-1} V_{i-1} after tile i's softmax, before the
    rescale by alpha_i, and the last tile's product after the loop."""
    bh, s, d = q.shape
    dv = v.shape[-1]

    def pad(t, width):
        return torch.nn.functional.pad(t.float(), (0, width - t.shape[-1]))

    qf, kf, vf = pad(q, TILE[d]), pad(k, TILE[d]), pad(v, TILE[dv])
    c = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    out = torch.empty(bh, s, TILE[dv])
    for q0 in range(0, s, BQ):
        rows = torch.arange(q0, min(q0 + BQ, s))
        m = torch.full((bh, len(rows)), -1e30)
        l = torch.zeros(bh, len(rows))
        acc = torch.zeros(bh, len(rows), vf.shape[-1])
        first = max(0, q0 - window + 1) // BK if window else 0
        if window and q0 >= window:
            first += late_skip
        pending = None   # the product issued with the next tile's S
        for t in range(first, int(rows[-1]) // BK + 1):
            keys = torch.arange(t * BK, min(t * BK + BK, s))
            sc = torch.einsum("bqd,bkd->bqk", qf[:, rows], kf[:, keys])
            keep = keys[None, :] <= rows[:, None]
            if window:
                keep &= rows[:, None] - keys[None, :] < window
            sc = torch.where(keep, sc, -math.inf)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2((m - m_new) * c)
            e = torch.exp2(sc * c - (m_new * c)[..., None])
            l = l * alpha + e.sum(-1)
            p = e.bfloat16().float()            # rounded before p.V
            pv = torch.einsum("bqk,bkd->bqd", p, vf[:, keys])
            if order == "serial":
                acc = acc * alpha[..., None] + pv
            else:
                if pending is not None:
                    acc = acc + pending
                acc = acc * alpha[..., None]
                pending = pv
            m = m_new
        if pending is not None:
            acc = acc + pending
        out[:, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out[..., :dv]


def _inputs(bh, s, d, seed):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("s", [100, 256])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("d", [32, 64, 80, 96, 120, 128])
def test_tiled_emulation_matches_attention_plain(d, window, s):
    """S 100 ends inside the first key tile; S 256 crosses two."""
    q, k, v = (torch.tensor(x).bfloat16() for x in _inputs(3, s, d, s + d))
    got = emulate(q, k, v, window)
    want = attention_plain(q, k, v, window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL)
    assert bf16_excess(got, want) <= 1


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("d", [32, 64, 80, 96, 120, 128])
def test_tiled_emulation_matches_pallas(d, window):
    """At S 256, which the Pallas wrapper's 128-blocks divide."""
    ref = load_reference()
    x = _inputs(3, 256, d, d)
    want = ref.flash_attention.flash_attention_pallas(
        *(jnp.asarray(t, jnp.bfloat16) for t in x), window=window,
        interpret=True, blk_q=BQ, blk_k=BK)
    got = emulate(*(torch.tensor(t).bfloat16() for t in x), window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("s,window", [(1024, None), (300, 64)])
def test_tiled_emulation_at_the_mla_pair(s, window):
    """(d, dv) = (192, 128), the scale 1/sqrt(192): at the serve's
    prefill row length (8 of its 512 heads) and off the tile with a
    window, within the bf16 tolerance and the per-element bound."""
    rs = np.random.default_rng(s)
    q, k = (torch.tensor(rs.standard_normal((8, s, 192)).astype(
        np.float32)).bfloat16() for _ in range(2))
    v = torch.tensor(rs.standard_normal((8, s, 128)).astype(
        np.float32)).bfloat16()
    got = emulate(q, k, v, window)
    want = attention_plain(q, k, v, window)
    assert got.shape == (8, s, 128)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL)
    x = bf16_excess(got, want)
    print(f"bf16_excess at (8, {s}, 192 -> 128) window {window}: {x:.3f}")
    assert x <= 1


def test_tiled_emulation_at_the_mla_pair_matches_pallas():
    """The reference's Pallas kernel (interpret mode) at (192, 128)."""
    ref = load_reference()
    rs = np.random.default_rng(192)
    x = [rs.standard_normal((2, 256, w)).astype(np.float32)
         for w in (192, 192, 128)]
    want = ref.flash_attention.flash_attention_pallas(
        *(jnp.asarray(t, jnp.bfloat16) for t in x), interpret=True,
        blk_q=BQ, blk_k=BK)
    got = emulate(*(torch.tensor(t).bfloat16() for t in x))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("fault", [None, "late_t_first", "no_window",
                                   "window_minus_1"])
def test_per_element_bound_rejects_planted_faults(fault):
    """At S 2048 and a window of 1024 (h2o-danube3's call halved, d 120):
    the emulation meets ``bf16_excess`` <= 1 against ``attention_plain``;
    the late query tiles skipping their first key tile, the window left
    out, or a window one key short, each fail it."""
    q, k, v = (torch.tensor(x).bfloat16()
               for x in _inputs(2, 2048, 120, 1024))
    want = attention_plain(q, k, v, 1024)
    got = {None: lambda: emulate(q, k, v, 1024),
           "late_t_first": lambda: emulate(q, k, v, 1024, late_skip=1),
           "no_window": lambda: emulate(q, k, v, None),
           "window_minus_1": lambda: emulate(q, k, v, 1023)}[fault]()
    x = bf16_excess(got, want)
    assert x <= 1 if fault is None else x > 1, x


@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("d,dv", [(32, 32), (64, 64), (80, 80), (96, 96),
                                  (120, 120), (128, 128), (192, 128)])
def test_overlapped_order_equals_serial_bit_for_bit(d, dv, window):
    """At every head dim of the kernel's tiles and MLA's (192, 128), S
    1084 (9 query tiles, the last with 60 rows) and a window of 200 (its
    edge inside a key tile): the kernel's issue order gives the serial
    order's float32 output exactly."""
    rs = np.random.default_rng(d + dv)
    q, k = (torch.tensor(rs.standard_normal((2, 1084, d)).astype(
        np.float32)).bfloat16() for _ in range(2))
    v = torch.tensor(rs.standard_normal((2, 1084, dv)).astype(
        np.float32)).bfloat16()
    serial = emulate_f32(q, k, v, window, order="serial")
    overlapped = emulate_f32(q, k, v, window, order="overlapped")
    assert serial.dtype == torch.float32 and serial.shape == (2, 1084, dv)
    assert torch.equal(overlapped, serial)
