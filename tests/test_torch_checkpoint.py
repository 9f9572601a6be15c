"""The port's checkpoint package: the cases of tests/test_checkpoint.py
on the port's trees (nested dicts of tensors), the file layout shared
with the reference (each side reads what the other wrote), and property
tests whose integer draws stay inside each dtype's range."""
import os

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch import checkpoint as ckpt
from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.models.transformer import init_params
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return (torch.zeros_like(tree) if torch.is_tensor(tree)
            else np.zeros_like(tree))


def _leaves(tree):
    return ckpt._flatten_with_paths(tree)[1]


def test_roundtrip(tmp_path):
    params = init_params(get_config("qwen2-0.5b").smoke(), rng.PRNGKey(0),
                         device="cpu")
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, params)
    assert ckpt.latest_step(d) == 3
    restored = ckpt.restore(d, _zeros_like(params))
    for a, b in zip(_leaves(params), _leaves(restored)):
        assert torch.is_tensor(b) and b.dtype == a.dtype
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_restore_puts_leaves_on_the_target_dtype(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": torch.arange(4.0), "k": torch.tensor([1, 2])})
    out = ckpt.restore(d, {"w": torch.zeros(4, dtype=torch.float64),
                           "k": np.zeros(2, np.int32)})
    assert out["w"].dtype == torch.float64
    assert isinstance(out["k"], np.ndarray) and out["k"].dtype == np.int32
    np.testing.assert_array_equal(out["k"], [1, 2])


def test_latest_pointer_advances(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones(2, 2)}}
    ckpt.save(d, 1, tree)
    tree2 = {"a": torch.arange(4.0) * 2, "b": {"c": torch.zeros(2, 2)}}
    ckpt.save(d, 2, tree2)
    out = ckpt.restore(d, _zeros_like(tree))
    torch.testing.assert_close(out["a"], tree2["a"], rtol=0, atol=0)


def test_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.ones(3)})
    with pytest.raises(ValueError):
        ckpt.restore(d, {"a": torch.ones(4)})


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"), {"a": torch.ones(1)})


def _corrupt_latest(d, content):
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write(content)


@pytest.mark.parametrize("content", ["", "garbage", "step_", "step_00x1"])
def test_corrupt_latest_falls_back_to_scan(tmp_path, content):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.arange(3.0)})
    ckpt.save(d, 4, {"a": torch.arange(3.0) * 4})
    _corrupt_latest(d, content)
    assert ckpt.latest_step(d) == 4
    out = ckpt.restore(d, {"a": torch.zeros(3)})
    torch.testing.assert_close(out["a"], torch.arange(3.0) * 4)


def test_stale_latest_pointing_at_missing_dir_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 2, {"a": torch.ones(2)})
    _corrupt_latest(d, "step_00000099")
    assert ckpt.latest_step(d) == 2


def test_missing_latest_falls_back_to_scan(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, {"a": torch.ones(2)})
    os.remove(os.path.join(d, "LATEST"))
    assert ckpt.latest_step(d) == 7


def test_latest_step_missing_dir_returns_none(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "nope")) is None


def test_orphaned_tmp_dirs_are_collected_on_next_save(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(os.path.join(d, "tmpdeadbeef"))
    with open(os.path.join(d, "tmpdeadbeef", "arrays.npz"), "wb") as f:
        f.write(b"partial")
    with open(os.path.join(d, "tmporphanfile"), "w") as f:
        f.write("x")
    ckpt.save(d, 1, {"a": torch.ones(2)})
    assert not any(n.startswith("tmp") for n in os.listdir(d))
    assert ckpt.latest_step(d) == 1
    assert ckpt.gc_tmp(d) == [] and ckpt.gc_tmp(str(tmp_path / "no")) == []


def test_crash_mid_save_leaves_previous_checkpoint_usable(tmp_path,
                                                          monkeypatch):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.arange(4.0)})

    def boom(*a, **k):
        raise RuntimeError("disk died")

    monkeypatch.setattr(ckpt.np, "savez", boom)
    with pytest.raises(RuntimeError):
        ckpt.save(d, 2, {"a": torch.arange(4.0) * 2})
    monkeypatch.undo()
    assert ckpt.latest_step(d) == 1
    out = ckpt.restore(d, {"a": torch.zeros(4)})
    torch.testing.assert_close(out["a"], torch.arange(4.0))
    ckpt.save(d, 2, {"a": torch.arange(4.0) * 2})
    assert not any(n.startswith("tmp") for n in os.listdir(d))
    assert ckpt.latest_step(d) == 2


def test_retention_keeps_last_k(tmp_path):
    d = str(tmp_path / "ck")
    for step in range(1, 6):
        ckpt.save(d, step, {"a": torch.full((2,), float(step))}, keep=2)
    assert ckpt.steps(d) == [4, 5]
    assert ckpt.latest_step(d) == 5
    out = ckpt.restore(d, {"a": torch.zeros(2)}, step=4)
    torch.testing.assert_close(out["a"], torch.full((2,), 4.0))


def test_retention_rejects_nonpositive_keep(tmp_path):
    with pytest.raises(ValueError):
        ckpt.save(str(tmp_path / "ck"), 1, {"a": torch.ones(1)}, keep=0)


def test_path_mismatch_same_shapes_raises_with_diff(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w1": torch.ones(3), "w2": torch.zeros(3)})
    with pytest.raises(ValueError, match="w3"):
        ckpt.restore(d, {"w1": torch.ones(3), "w3": torch.zeros(3)})


def test_nested_path_mismatch_lists_both_sides(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"m": {"a": torch.ones(2)}, "b": torch.zeros(2)})
    with pytest.raises(ValueError) as ei:
        ckpt.restore(d, {"m": {"z": torch.ones(2)}, "b": torch.zeros(2)})
    assert "m/a" in str(ei.value) and "m/z" in str(ei.value)


def test_shape_mismatch_names_the_leaf(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.ones(3), "b": torch.ones(2, 2)})
    with pytest.raises(ValueError, match="'b'"):
        ckpt.restore(d, {"a": torch.ones(3), "b": torch.ones(2, 3)})


def test_meta_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    meta = {"round": 12, "dp_rounds": 7, "converged_round": None}
    ckpt.save(d, 12, {"a": torch.ones(2)}, meta=meta)
    assert ckpt.load_meta(d) == meta
    assert ckpt.load_meta(d, step=12) == meta


def test_restore_tree_rebuilds_nested_dicts(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"g": {"w": torch.arange(6.0).reshape(2, 3),
                  "b": torch.zeros(3)},
            "round_key": np.array([1, 2], np.uint32)}
    ckpt.save(d, 5, tree, meta={"round": 5})
    out, meta = ckpt.restore_tree(d)
    assert meta == {"round": 5}
    np.testing.assert_array_equal(out["g"]["w"], tree["g"]["w"].numpy())
    np.testing.assert_array_equal(out["g"]["b"], tree["g"]["b"].numpy())
    np.testing.assert_array_equal(out["round_key"], tree["round_key"])
    assert out["round_key"].dtype == np.uint32


def test_restore_tree_bare_array(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, torch.arange(5.0))
    out, _ = ckpt.restore_tree(d)
    np.testing.assert_array_equal(out, np.arange(5.0, dtype=np.float32))


# ---- the file layout is the reference's ----------------------------------


def _mixed_tree():
    return {"key": np.array([0, 42], np.uint32),
            "g_params": {"conv1": {"w": np.arange(24.0, dtype=np.float32)
                                   .reshape(2, 3, 4), "b": np.ones(2)}},
            "gout": np.full((3, 3), 1 / 3, np.float32),
            "y": np.arange(5, dtype=np.int64)}


def test_the_reference_reads_the_ports_checkpoints(tmp_path):
    ref = load_reference().checkpoint
    tree = _mixed_tree()
    d = str(tmp_path / "ck")
    ckpt.save(d, 9, _as_tensors(tree), meta={"round": 9})
    assert ref.latest_step(d) == 9
    out, meta = ref.restore_tree(d)
    assert meta == {"round": 9}
    want_paths, want_leaves, _ = ref._flatten_with_paths(tree)
    got_paths, got_leaves, _ = ref._flatten_with_paths(out)
    assert got_paths == want_paths == ckpt._flatten_with_paths(tree)[0]
    for a, b in zip(want_leaves, got_leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_the_port_reads_the_references_checkpoints(tmp_path):
    ref = load_reference().checkpoint
    tree = _mixed_tree()
    d = str(tmp_path / "ck")
    ref.save(d, 4, tree, meta={"round": 4}, keep=1)
    assert ckpt.latest_step(d) == 4 and ckpt.load_meta(d) == {"round": 4}
    out = ckpt.restore(d, _zeros_like(_as_tensors(tree)))
    for a, b in zip(_leaves(tree), _leaves(out)):
        got = b.numpy() if torch.is_tensor(b) else b
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a)


# ---- properties (hypothesis) ---------------------------------------------
# Each dtype draws integers inside its own range (a draw below zero cannot
# be stored in uint32, which numpy 2 refuses).

_KEYS = st.text(alphabet="abcdefgh", min_size=1, max_size=4)
_SHAPES = st.lists(st.integers(1, 4), min_size=0, max_size=3).map(tuple)
_RANGES = {np.float32: (-1000, 1000), np.int32: (-1000, 1000),
           np.uint32: (0, 1000), np.float64: (-1000, 1000),
           np.int64: (-2 ** 40, 2 ** 40), np.uint8: (0, 255)}


@st.composite
def leaves(draw):
    shape = draw(_SHAPES)
    dtype = draw(st.sampled_from(sorted(_RANGES, key=str)))
    lo, hi = _RANGES[dtype]
    n = int(np.prod(shape, dtype=np.int64))
    vals = draw(st.lists(st.integers(lo, hi), min_size=n, max_size=n))
    return np.asarray(vals, dtype=dtype).reshape(shape)


def trees(depth=2):
    leaf = leaves()
    if depth == 0:
        return leaf
    return st.dictionaries(_KEYS, st.one_of(leaf, trees(depth - 1)),
                           min_size=1, max_size=3)


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    return tree if tree.dtype == np.uint32 else torch.as_tensor(tree)


@given(tree=trees(), step=st.integers(0, 10 ** 7))
@settings(max_examples=30, deadline=None, database=None)
def test_save_restore_tree_roundtrip(tmp_path_factory, tree, step):
    d = str(tmp_path_factory.mktemp("ck"))
    ckpt.save(d, step, _as_tensors(tree))
    assert ckpt.latest_step(d) == step
    out, _ = ckpt.restore_tree(d)
    paths_in, leaves_in = ckpt._flatten_with_paths(tree)
    paths_out, leaves_out = ckpt._flatten_with_paths(out)
    assert paths_in == paths_out
    for a, b in zip(leaves_in, leaves_out):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@given(tree=trees(), step=st.integers(0, 100))
@settings(max_examples=20, deadline=None, database=None)
def test_restore_into_zeroed_template(tmp_path_factory, tree, step):
    d = str(tmp_path_factory.mktemp("ck"))
    tensors = _as_tensors(tree)
    ckpt.save(d, step, tensors)
    out = ckpt.restore(d, _zeros_like(tensors))
    for a, b in zip(_leaves(tree), _leaves(out)):
        got = b.numpy() if torch.is_tensor(b) else b
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a)


@given(tree=trees())
@settings(max_examples=30, deadline=None, database=None)
def test_leaf_order_is_the_references(tree):
    """Sorted-path order is ``jax.tree_util``'s order for dicts."""
    ref = load_reference().checkpoint
    paths, leaves_, _ = ref._flatten_with_paths(tree)
    got_paths, got_leaves = ckpt._flatten_with_paths(tree)
    assert got_paths == paths
    assert all(a is b for a, b in zip(got_leaves, leaves_))
    assert len(jax.tree.leaves(tree)) == len(got_leaves)


@given(tree=st.dictionaries(_KEYS, leaves(), min_size=2, max_size=4),
       data=st.data())
@settings(max_examples=20, deadline=None, database=None)
def test_renamed_leaf_always_raises(tmp_path_factory, tree, data):
    d = str(tmp_path_factory.mktemp("ck"))
    ckpt.save(d, 1, tree)
    old = data.draw(st.sampled_from(sorted(tree)))
    bad = dict(tree)
    bad[old + "_renamed"] = bad.pop(old)
    with pytest.raises(ValueError):
        ckpt.restore(d, bad)
