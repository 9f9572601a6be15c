"""The port's LM serve driver end to end against the reference's, on the
CPU at the qwen2-0.5b smoke config (2 layers, d_model 256, vocab 512)
and the mamba2-370m smoke config (2 layers, d_model 256, 16 SSM heads of
32, state 16, chunk 32, vocab 512).

float32: both draw the weights from PRNGKey(0) and the prompts from
PRNGKey(1) (the port through its threefry, weights within 4 float32
ulps), so the greedy tokens must be equal and the prefill logits agree
to 1e-4.  bfloat16: the reference's own weights carried across; logits
within 2**-5 (4 bf16 ulps at 1.0) and the same greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, rng
from repro_torch.data import synthetic_tokens
from repro_torch.launch import serve as port_serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer
from test_torch_reference import load_reference


def _quiet(*_):
    pass


def test_serve_gives_the_reference_tokens():
    ref = load_reference()
    want = ref.serve.serve("qwen2-0.5b", 2, 64, 6, smoke=True, log=_quiet)
    lines = []
    got = port_serve.serve("qwen2-0.5b", 2, 64, 6, smoke=True,
                           log=lines.append, device="cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lines[0] == "arch=qwen2-0.5b params=1.90M batch=2 prompt=64 gen=6"
    assert lines[1].startswith("prefill: ") and "tok/s" in lines[1]
    assert lines[2].startswith("decode : ") and "tok/s" in lines[2]
    assert lines[3] == ("sample continuation (seq 0): "
                        f"{got[0, :12].tolist()}")


def test_serve_prefill_logits_match_reference_float32():
    """The serve path's own weights and prompts (same keys on both
    sides): last-token prefill logits within 1e-4."""
    ref = load_reference()
    cfg = configs.get_config("qwen2-0.5b-smoke")
    rcfg = ref.configs.get_config("qwen2-0.5b-smoke")
    pj = ref.transformer.init_params(rcfg, jax.random.PRNGKey(0))
    prompts = ref.synthetic.synthetic_tokens(jax.random.PRNGKey(1), 2, 64,
                                             cfg.vocab_size)
    lj, _ = jax.jit(ref.steps.make_prefill_step(rcfg, 70))(
        pj, {"tokens": prompts})
    pt = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    toks = synthetic_tokens(rng.PRNGKey(1), 2, 64, cfg.vocab_size,
                            device="cpu")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(prompts))
    lt, _ = make_prefill_step(cfg, 70)(pt, {"tokens": toks})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-4)


def test_serve_steps_bfloat16_smoke():
    ref = load_reference()
    cfg = dataclasses.replace(configs.get_config("qwen2-0.5b-smoke"),
                              param_dtype="bfloat16")
    rcfg = ref.configs.ArchConfig(**dataclasses.asdict(cfg))
    pj = jax.tree.map(np.asarray, ref.transformer.init_params(
        rcfg, jax.random.PRNGKey(0)))
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    toks = np.asarray(ref.synthetic.synthetic_tokens(
        jax.random.PRNGKey(1), 2, 64, cfg.vocab_size))
    lj, cj = jax.jit(ref.steps.make_prefill_step(rcfg, 70))(
        pj, {"tokens": jnp.asarray(toks)})
    lt, ct = make_prefill_step(cfg, 70)(pt, {"tokens": torch.tensor(toks)})
    assert lt.dtype == torch.bfloat16
    np.testing.assert_allclose(lt.float().numpy(),
                               np.asarray(lj, np.float32), rtol=0,
                               atol=2.0 ** -5)
    for k in ("k", "v"):
        # cached k/v, |x| < 4: layer 2's inputs carry layer 1's bf16
        # rounding differences, so the bound is absolute: 2 bf16 ulps at
        # the top of the range
        np.testing.assert_allclose(
            ct["layers"][k].float().numpy(),
            np.asarray(cj["layers"][k], np.float32), rtol=0,
            atol=2.0 ** -5)
    nj = jnp.argmax(lj, -1).astype(jnp.int32)
    nt = torch.argmax(lt, -1)
    dec_j = jax.jit(ref.steps.make_decode_step(rcfg))
    dec_t = make_decode_step(cfg)
    for _ in range(5):
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        nj, cj = dec_j(pj, {"tokens": nj[:, None], "cache": cj})
        nt, ct = dec_t(pt, {"tokens": nt[:, None], "cache": ct})
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def test_serve_main_runs_on_the_cpu(capsys):
    port_serve.main(["--arch", "qwen2-0.5b", "--batch", "1",
                     "--prompt-len", "8", "--gen", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "params=1.90M" in out and "sample continuation" in out


# the reference's serve("mamba2-370m", 2, 40, 6) on the smoke config
MAMBA2_TOKENS = [[274, 355, 209, 166, 369, 506],
                 [441, 328, 178, 156, 178, 478]]


def test_mamba2_serve_gives_the_reference_tokens():
    """Prompt 40 with chunk 32: the prefill pads to two chunks."""
    ref = load_reference()
    want = ref.serve.serve("mamba2-370m", 2, 40, 6, smoke=True, log=_quiet)
    lines = []
    got = port_serve.serve("mamba2-370m", 2, 40, 6, smoke=True,
                           log=lines.append, device="cpu")
    np.testing.assert_array_equal(np.asarray(want), MAMBA2_TOKENS)
    np.testing.assert_array_equal(got.numpy(), MAMBA2_TOKENS)
    assert lines[0] == "arch=mamba2-370m params=1.08M batch=2 prompt=40 gen=6"


@pytest.mark.parametrize("prompt", [40, 64])
def test_mamba2_prefill_logits_and_cache_match_reference(prompt):
    ref = load_reference()
    cfg = configs.get_config("mamba2-370m-smoke")
    rcfg = ref.configs.get_config("mamba2-370m-smoke")
    pj = ref.transformer.init_params(rcfg, jax.random.PRNGKey(0))
    prompts = ref.synthetic.synthetic_tokens(jax.random.PRNGKey(1), 2,
                                             prompt, cfg.vocab_size)
    lj, cj = jax.jit(ref.steps.make_prefill_step(rcfg, prompt + 6))(
        pj, {"tokens": prompts})
    pt = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    toks = synthetic_tokens(rng.PRNGKey(1), 2, prompt, cfg.vocab_size,
                            device="cpu")
    lt, ct = make_prefill_step(cfg, prompt + 6)(pt, {"tokens": toks})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-4)
    assert ct["pos"] == int(cj["pos"]) == prompt
    for k in ("state", "conv"):
        np.testing.assert_allclose(ct["layers"][k].numpy(),
                                   np.asarray(cj["layers"][k]), rtol=0,
                                   atol=1e-4)


def test_serve_main_runs_mamba2_on_the_cpu(capsys):
    port_serve.main(["--arch", "mamba2-370m", "--batch", "1",
                     "--prompt-len", "8", "--gen", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "params=1.08M" in out and "sample continuation" in out
