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
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import attention_plain
from test_torch_reference import load_reference

BQ = BK = 128           # the kernel's query and key tiles
ATOL = 2 * 2.0 ** -6    # tests/test_torch_cuda.py, the bfloat16 cases


def emulate(q, k, v, window=None):
    """q, k: (BH, S, d), v: (BH, S, dv), bfloat16 -> (BH, S, dv) bfloat16,
    by the kernel's tiles and online softmax, in float32."""
    bh, s, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    c = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    out = torch.empty(bh, s, v.shape[-1])
    for q0 in range(0, s, BQ):
        rows = torch.arange(q0, min(q0 + BQ, s))
        m = torch.full((bh, len(rows)), -1e30)
        l = torch.zeros(bh, len(rows))
        acc = torch.zeros(bh, len(rows), v.shape[-1])
        first = max(0, q0 - window + 1) // BK if window else 0
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
            acc = (acc * alpha[..., None]
                   + torch.einsum("bqk,bkd->bqd", p, vf[:, keys]))
            m = m_new
        out[:, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.bfloat16()


def _inputs(bh, s, d, seed):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("s", [100, 256])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_tiled_emulation_matches_attention_plain(d, window, s):
    """S 100 ends inside the first key tile; S 256 crosses two."""
    q, k, v = (torch.tensor(x).bfloat16() for x in _inputs(3, s, d, s + d))
    got = emulate(q, k, v, window)
    want = attention_plain(q, k, v, window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("d", [32, 64, 128])
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
