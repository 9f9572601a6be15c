"""The port's examples (``examples/torch_*.py``) against the reference's.

* Quickstart: ``main(device="cpu", ...)`` at cut budgets against the
  reference's quickstart flow (``examples/quickstart.py``: 5 devices x
  500 digits from PRNGKey(0), mix2fld, 2 rounds, the asymmetric
  channel) at the same budgets, run live: acc and loss within 1e-4, the
  seed set's sizes, label kind and cycle histogram equal.
* Fig. 2: the example's grid (labels, configs, channels, partitions and
  pool size) equals the one ``benchmarks/bench_protocols.py``'s ``run``
  builds, with and without ``quick``; then the reference's ``run`` itself
  on its fl and mix2fld points at a tiny size (its ``PROTOCOLS`` cut,
  and the example's, its ``save_result`` sent to a temporary directory)
  against the example's ``run``: acc within 1e-4, uplink_ok,
  converged_round and the program count equal.
* Each example's command line once, in a subprocess on the CPU at its
  cheapest arguments (all four started with the module): exit 0 and its
  closing lines.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_reference import load_reference
from test_torch_reference import one_thread_per_module  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import torch_paper_fig2  # noqa: E402
import torch_quickstart  # noqa: E402

QUICK_BUDGET = dict(local_iters=8, server_iters=8)
# the Fig. 2 run at a tiny size: a non-IID split of n_local = 2*2 + 8*6
TINY_FIG2 = dict(local_iters=4, server_iters=4, max_rounds=2, num_devices=4,
                 n_local=52)
LIVE_PROTOCOLS = ("fl", "mix2fld")


def reference_quickstart(**overrides):
    """examples/quickstart.py's flow on the reference, ``overrides``
    applied to its FederatedConfig."""
    ref = load_reference()
    x, y = ref.data.synthetic_images(jax.random.PRNGKey(0), 3500)
    dev_x, dev_y = ref.data.partition_iid(x[:2500], y[:2500], 5, 500, 10)
    fc = ref.protocols.FederatedConfig(**dict(torch_quickstart.CONFIG,
                                              **overrides))
    ch = ref.channel.ChannelConfig(num_devices=5)
    return ref.protocols.FederatedTrainer(ref.cnn.CNN(), fc, ch).run(
        dev_x, dev_y, jnp.asarray(x[2500:]), jnp.asarray(y[2500:]))


def test_quickstart_matches_reference():
    lines = []
    got = torch_quickstart.main("cpu", log=lines.append, **QUICK_BUDGET)
    want = reference_quickstart(**QUICK_BUDGET)
    assert len(got["acc"]) == len(want["acc"]) == 2
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-4)
    assert got["uplink_ok"] == [int(u) for u in want["uplink_ok"]]
    for k in ("n_uploaded", "n_train", "hard_labels", "cycle_hist"):
        assert got["seeds"][k] == want["seeds"][k], k
    text = "\n".join(lines)
    for line in (f"uploaded mixed-up seeds : {want['seeds']['n_uploaded']}",
                 f"label-cycle histogram   : {want['seeds']['cycle_hist']}",
                 f"accuracy after 2 rounds: {want['acc'][-1]:.3f}"):
        assert line in text, line


class _GridSeen(Exception):
    pass


def reference_grid(monkeypatch, **kw):
    """The grid and pool size ``bench_protocols.run(**kw)`` builds (its
    SweepRunner and sample_pool replaced by recorders; nothing runs)."""
    bp = load_reference().bench_protocols
    seen = {}

    def pool(n_train, **_):
        seen["n_train"] = n_train
        return None, None, None, None

    def runner(model, grid, *pool_):
        seen["grid"] = grid
        raise _GridSeen

    monkeypatch.setattr(bp, "sample_pool", pool)
    monkeypatch.setattr(bp, "SweepRunner", runner)
    with pytest.raises(_GridSeen):
        bp.run(**kw)
    return seen["grid"], seen["n_train"]


def _fields(obj) -> dict:
    """A dataclass's fields, nested dataclasses as dicts too (the port's
    and the reference's classes compare by value)."""
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("quick", [False, True])
def test_fig2_grid_is_the_reference_grid(monkeypatch, quick):
    want, want_n = reference_grid(monkeypatch, quick=quick)
    got, _, got_n = torch_paper_fig2.fig2_grid(quick=quick)
    assert got_n == want_n
    assert got.shape == want.shape == (5, 2, 2)
    assert got.labels() == want.labels()
    assert [p.scheme for p in got.parts] == [p.scheme for p in want.parts]
    assert [_fields(p) for p in got.parts] == [_fields(p) for p in want.parts]
    for (fc, ch), (rfc, rch) in zip(got.points, want.points):
        ref_fc = _fields(rfc)
        assert {k: v for k, v in _fields(fc).items() if k in ref_fc} == \
            ref_fc
        assert _fields(ch) == _fields(rch)


def test_fig2_run_matches_reference(monkeypatch, tmp_path):
    bp = load_reference().bench_protocols
    saved = {}

    def save_result(name, payload):
        saved[name] = payload
        return str(tmp_path / f"{name}.json")

    monkeypatch.setattr(bp, "save_result", save_result)
    monkeypatch.setattr(bp, "PROTOCOLS", LIVE_PROTOCOLS)
    monkeypatch.setattr(torch_paper_fig2, "PROTOCOLS", LIVE_PROTOCOLS)
    want = bp.run(**TINY_FIG2)
    lines = []
    got = torch_paper_fig2.run(**TINY_FIG2, device="cpu", out=tmp_path,
                               log=lines.append)
    assert saved["protocols_fig2"] is want
    assert sorted(got) == sorted(want) and len(got) == 8
    for k, w in want.items():
        g = got[k]
        np.testing.assert_allclose(g["acc"], w["acc"], rtol=0, atol=1e-4,
                                   err_msg=k)
        assert g["uplink_ok"] == [int(u) for u in w["uplink_ok"]], k
        assert g["converged_round"] == w["converged_round"], k
        assert g["programs"] == w["programs"] == len(LIVE_PROTOCOLS), k
    assert (tmp_path / "protocols_fig2.json").is_file()
    assert any(line.startswith("heterogeneous sweep: 8 points, 2 programs")
               for line in lines)


CLI = {
    "torch_quickstart.py": (["--local-iters", "2", "--server-iters", "2",
                             "--rounds", "1"],
                            "accuracy after 1 rounds"),
    "torch_paper_fig2.py": (["--devices", "4", "--n-local", "52",
                             "--local-iters", "2", "--server-iters", "2",
                             "--rounds", "1"],
                            "=== final accuracies ==="),
    "torch_serve_batched.py": (["--batch", "2", "--prompt-len", "8",
                                "--gen", "4"],
                               "sample continuation (seq 0)"),
    "torch_train_lm_mix2fld.py": (["--steps", "1", "--sync-every", "1",
                                   "--batch", "1", "--seq", "16",
                                   "--log-every", "1"],
                                  "step    0 loss="),
}


@pytest.fixture(scope="module", autouse=True)
def command_lines(tmp_path_factory):
    """Each example's command line started in a subprocess (one torch
    thread each) when the module starts, so that they run beside the
    in-process comparisons; the tests below read them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    runs = {}
    for script, (args, _) in CLI.items():
        cwd = tmp_path_factory.mktemp(script.removesuffix(".py"))
        if script == "torch_paper_fig2.py":
            args = args + ["--out", str(cwd)]
        runs[script] = (cwd, subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / script), "--device",
             "cpu", *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=cwd, env=env))
    yield runs
    for _, proc in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("script", sorted(CLI))
def test_example_command_line_runs_on_the_cpu(script, command_lines):
    cwd, proc = command_lines[script]
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-4000:]
    assert CLI[script][1] in stdout, stdout[-2000:]
    if script == "torch_paper_fig2.py":
        assert (cwd / "protocols_fig2.json").is_file()
