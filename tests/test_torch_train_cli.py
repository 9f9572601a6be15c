"""The port's training CLI (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``), on the CPU.

``--mode lm`` at ``tests/test_drivers.py:32-38``'s tiny preset (the
port's cover for ``test_lm_train_driver_loss_decreases``, which cannot
run under the installed jax, ROADMAP C1): every step's loss within 1e-4
of the reference's run, every leaf finite, the server stack untouched by
the local steps that follow a sync, and the seq-1024 failure of the
conversion's attention raised as the reference raises it.  ``--mode
paper`` and ``main`` are driven through their arguments.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch import train as T
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401


def _sorted_leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _args(**kw):
    base = dict(arch="qwen2-0.5b", preset="25m", pods=2, steps=8, batch=2,
                seq=32, sync_every=4, ks_iters=1, log_every=1, ckpt_dir="",
                device="cpu")
    return types.SimpleNamespace(**dict(base, **kw))


def _ref_run(args, monkeypatch):
    """The reference's run_lm at the tiny preset; the loss of every step
    (read where run_lm logs it) and the pod params."""
    ref = load_reference().train
    losses = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def mean(x, *a, **kw):
            losses.append(np.asarray(x))
            return jnp.mean(x, *a, **kw)

    monkeypatch.setattr(ref, "_preset", lambda cfg, _: T.tiny_preset(cfg))
    monkeypatch.setattr(ref, "jnp", Recorder())
    out = ref.run_lm(args)
    return losses, out


def _tiny():
    return T.tiny_preset(get_config("qwen2-0.5b"))


def _port_run(args, monkeypatch):
    """The port's run_lm at the tiny preset: its pod params, its history
    and each sync's returned server stack (with a copy taken then)."""
    syncs = []
    make_sync = T.make_fd_sync_step

    def sync(cfg, n_pods, ks_iters):
        fd = make_sync(cfg, n_pods, ks_iters=ks_iters)

        def run(*a):
            stack, gout = fd(*a)
            syncs.append((stack, steps.tree_map(torch.clone, stack)))
            return stack, gout
        return run

    monkeypatch.setattr(T, "make_fd_sync_step", sync)
    pp, hist = T.run_lm(args, cfg=_tiny())
    return pp, hist, syncs


def test_lm_train_cli_matches_reference(monkeypatch, capsys):
    args = _args()
    want, want_pp = _ref_run(args, monkeypatch)
    pp, hist, syncs = _port_run(args, monkeypatch)
    got = hist["loss"]
    assert len(got) == len(want) == args.steps
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    # loss decreases over the run, as tests/test_drivers.py's name says
    assert float(np.mean(got[-1])) < float(np.mean(got[0]))
    for leaf in steps.tree_leaves(pp):
        assert leaf.shape[0] == args.pods
        assert torch.isfinite(leaf).all()
    for a, b in zip(_sorted_leaves(pp),
                    jax.tree.leaves(jax.tree.map(np.asarray, want_pp))):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)
    # the server stack the last sync returned is what the pods trained
    # from, and the local steps after it left it as it was
    assert len(syncs) == args.steps // args.sync_every
    stack, copy = syncs[-1]
    for a, b in zip(steps.tree_leaves(stack), steps.tree_leaves(copy)):
        assert torch.equal(a, b)
    out = capsys.readouterr().out
    assert "params=" in out and "step    7 loss=" in out
    # one timed call a step, two syncs of a favg and a conversion each;
    # no kernel launches on the CPU
    assert [len(hist[k]["ms"]) for k in ("local", "favg", "conv")] == \
        [8, 2, 2]
    assert not any(hist[k]["launches"][i] for k in ("local", "favg", "conv")
                   for i in range(len(hist[k]["launches"])))


def test_lm_train_cli_local_steps_leave_the_server_stack(monkeypatch):
    """Six steps with a sync after the fourth: the two local steps after
    the sync train the pods from the server stack without writing it."""
    pp, _, syncs = _port_run(_args(steps=6), monkeypatch)
    stack, copy = syncs[0]
    for a, b, c in zip(steps.tree_leaves(stack), steps.tree_leaves(copy),
                       steps.tree_leaves(pp)):
        assert torch.equal(a, b)
        assert not torch.equal(a, c)


def test_lm_train_cli_fails_at_seq_1024_as_the_reference(monkeypatch):
    """The seed batch has seq + 1 columns: at seq 1024 the conversion's
    attention sees T = 1025 > CHUNKED_THRESHOLD, no multiple of the
    query chunk, and both raise (neither pads)."""
    args = _args(seq=1024, steps=1, sync_every=1, batch=1, pods=1)
    with pytest.raises(AssertionError, match="q-chunk"):
        _ref_run(args, monkeypatch)
    with pytest.raises(ValueError, match="q-chunk"):
        _port_run(args, monkeypatch)


def test_lm_train_cli_checkpoint(monkeypatch, tmp_path):
    from repro_torch import checkpoint
    pp, _ = T.run_lm(_args(steps=2, sync_every=2, ckpt_dir=str(tmp_path)),
                     cfg=_tiny())
    tree, _ = checkpoint.restore_tree(str(tmp_path))
    assert checkpoint.latest_step(str(tmp_path)) == 2
    got, want = _sorted_leaves(tree), _sorted_leaves(steps.pod(pp, 0))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_main_parses_both_modes(monkeypatch):
    seen = {}
    monkeypatch.setattr(T, "run_paper", lambda a: seen.setdefault("p", a))
    monkeypatch.setattr(T, "run_lm", lambda a: seen.setdefault("l", a))
    T.main(["--mode", "paper", "--noniid", "--device", "cpu",
            "--rounds", "2"])
    T.main(["--mode", "lm", "--arch", "mamba2-370m", "--seq", "64"])
    assert seen["p"].noniid and seen["p"].device == "cpu"
    assert seen["p"].rounds == 2 and seen["p"].local_iters == 150
    assert seen["l"].arch == "mamba2-370m" and seen["l"].device is None
    assert {a.dest for a in T.parser()._actions} - {"device"} >= {
        "mode", "protocol", "devices", "rounds", "local_iters", "noniid",
        "symmetric", "arch", "preset", "pods", "steps", "batch", "seq",
        "sync_every", "ks_iters", "log_every", "ckpt_dir"}


@pytest.mark.parametrize("preset", ["25m", "100m", "full"])
def test_presets_match_reference(preset):
    ref = load_reference()
    for arch in ("qwen2-0.5b", "mamba2-370m", "zamba2-2.7b"):
        got = T._preset(get_config(arch), preset)
        want = ref.train._preset(ref.configs.get_config(arch), preset)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
