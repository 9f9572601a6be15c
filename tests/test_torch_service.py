"""The continuous federated service (``launch/service.py``) at the
reference tests' golden size (D = 4, K = 8, B = 16, K_s = 8, n_seed 6,
n_inverse 12; tests/test_service.py), held against the live reference.

Against the reference's service under churn and straggler timeouts:
acc and loss atol 1e-4, latency rtol 1e-6; ``uplink_ok``,
``n_straggle``, ``n_active`` and the active devices equal.  Within the
port, a killed and restored service reproduces the uninterrupted tail
bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.channel import ChannelConfig
from repro_torch.channel.payload import LinkConfig
from repro_torch.core.protocols import FederatedConfig, FederatedTrainer
from repro_torch.core.sampling import ChurnConfig, SamplerConfig
from repro_torch.core.seed_prep import summarize_seeds
from repro_torch.launch import service
from repro_torch.launch.serve import serve_classifier
from repro_torch.launch.service import FederatedService, InferenceEndpoint
from repro_torch.models import CNN
from test_torch_reference import (GOLDEN_CFG, GOLDEN_P_UP_DBM, golden_data,
                                  load_reference,
                                  one_thread_per_module)  # noqa: F401


CH = dict(num_devices=4, p_up_dbm=GOLDEN_P_UP_DBM)
# the churn and straggler regime of the reference's robustness tests
CH_STRAG = dict(CH, compute_mean_s=0.05, deadline_s=0.08)
CHURN = dict(p_active=0.6, min_active=2, seed=3)


def _cfg(protocol="fd", **kw):
    return FederatedConfig(protocol=protocol, **dict(GOLDEN_CFG, **kw))


def _svc(protocol="fd", ch=CH, churn=None, tmp=None, fc_kw=None, **kw):
    svc = FederatedService(
        CNN(), _cfg(protocol, **(fc_kw or {})), ChannelConfig(**ch),
        churn=ChurnConfig(**churn) if churn else None,
        ckpt_dir=str(tmp) if tmp else None, device="cpu", **kw)
    return svc.bind_data(*golden_data())


def _tail(records):
    keys = ("round", "acc", "loss", "round_latency_s", "uplink_ok",
            "n_active")
    return [{k: r[k] for k in keys} for r in records]


def _test_set():
    _, _, tx, ty = golden_data()
    return torch.tensor(tx), ty


def _leaves(tree):
    return ckpt._flatten_with_paths(tree)[1]


# ---- the reference's service ----------------------------------------------


def test_service_without_churn_matches_trainer_run():
    """Churn and stragglers off: the records are run()'s history bit for
    bit (the same stream through the same round)."""
    h = FederatedTrainer(CNN(), _cfg("fd"), ChannelConfig(**CH),
                         device="cpu").run(*golden_data())
    svc = _svc("fd")
    recs = svc.run_rounds(3)
    for k in ("acc", "loss", "round_latency_s", "uplink_ok"):
        assert [r[k] for r in recs] == h[k], k
    assert all(r["n_active"] == 4 and r["n_straggle"] == 0 for r in recs)
    assert svc.state.converged_round == h["converged_round"]


@pytest.mark.parametrize("protocol", ["fd", "mix2fld"])
def test_service_with_churn_and_stragglers_matches_reference(protocol):
    ref = load_reference()
    want = ref.service.FederatedService(
        None, ref.protocols.FederatedConfig(protocol=protocol, **GOLDEN_CFG),
        ref.channel.ChannelConfig(**CH_STRAG),
        churn=ref.sampling.ChurnConfig(**CHURN)).bind_data(
            *golden_data()).run_rounds(4)
    got = _svc(protocol, ch=CH_STRAG, churn=CHURN).run_rounds(4)
    assert len({r["n_active"] for r in got}) > 1
    assert sum(r["n_straggle"] for r in got) > 0
    for w, g in zip(want, got):
        for k in ("round", "uplink_ok", "n_straggle", "n_active"):
            assert g[k] == w[k], k
        np.testing.assert_array_equal(g["active"], w["active"])
        np.testing.assert_allclose(g["acc"], w["acc"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["round_latency_s"],
                                   w["round_latency_s"], rtol=1e-6)


# ---- a killed service resumes bit for bit ---------------------------------


@pytest.mark.parametrize("protocol", ["fd", "mix2fld"])
def test_killed_service_resumes_bit_identically(protocol, tmp_path):
    """A fresh service restoring the round-2 checkpoint reproduces the
    uninterrupted run's rounds 3 and 4 exactly, key bits included (the
    mix2fld case takes the round-1 seed set through the checkpoint)."""
    svc = _svc(protocol, ch=CH_STRAG, churn=CHURN, tmp=tmp_path / "ck")
    recs = svc.run_rounds(4)
    assert len({r["n_active"] for r in recs}) > 1

    svc2 = _svc(protocol, ch=CH_STRAG, churn=CHURN, tmp=tmp_path / "ck")
    assert svc2.restore(step=2) == 2
    assert svc2.state.key.dtype == torch.int64
    tail = svc2.run_rounds(2)
    assert _tail(tail) == _tail(recs[2:])
    torch.testing.assert_close(svc2.state.key, svc.state.key, rtol=0,
                               atol=0)
    for a, b in zip(_leaves(svc.state.g_params),
                    _leaves(svc2.state.g_params)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    for a, b in zip(_leaves(svc.state.dev_params),
                    _leaves(svc2.state.dev_params)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert svc2.state.converged_round == svc.state.converged_round
    # the resumed history is the full run's: the prefix from the meta,
    # the tail recomputed
    assert _tail(svc2.history) == _tail(svc.history)
    meta = ckpt.load_meta(str(tmp_path / "ck"))
    assert meta["protocol"] == protocol and meta["round"] == 4
    if protocol == "mix2fld":
        assert meta["seed_meta"] == summarize_seeds(svc.state.seeds)
        assert svc2.state.seeds["train_x"].shape == \
            svc.state.seeds["train_x"].shape
    assert ckpt.steps(str(tmp_path / "ck")) == [1, 2, 3, 4]


def test_checkpoint_tree_has_the_references_keys(tmp_path):
    svc = _svc("mix2fld", tmp=tmp_path / "ck", keep=2)
    svc.run_rounds(3)
    tree, meta = ckpt.restore_tree(str(tmp_path / "ck"))
    assert set(tree) == {"key", "g_params", "dev_params", "gout",
                         "dev_gout", "prev", "seeds"}
    assert tree["key"].dtype == np.uint32
    assert set(meta) == {"round", "cum_time_s", "converged_round",
                         "protocol", "dp_rounds", "dp_device_counts",
                         "seed_meta", "history"}
    assert ckpt.steps(str(tmp_path / "ck")) == [2, 3]


def test_crash_mid_save_resumes_from_last_good_checkpoint(tmp_path,
                                                          monkeypatch):
    """A failure while saving round 2 (the stand-in for a kill) leaves no
    round-2 checkpoint; a fresh service restores round 1 and reproduces
    rounds 2 and 3 of an uninterrupted run."""
    d = tmp_path / "ck"
    ref_recs = _svc("fd", ch=CH_STRAG, churn=CHURN,
                    tmp=tmp_path / "ref").run_rounds(3)
    svc = _svc("fd", ch=CH_STRAG, churn=CHURN, tmp=d)
    svc.run_rounds(1)
    real_savez = np.savez

    def boom(*a, **k):
        raise RuntimeError("killed mid-save")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(RuntimeError, match="killed mid-save"):
        svc.run_rounds(1)
    monkeypatch.setattr(np, "savez", real_savez)

    assert ckpt.latest_step(str(d)) == 1
    svc2 = _svc("fd", ch=CH_STRAG, churn=CHURN, tmp=d)
    assert svc2.restore() == 1
    assert _tail(svc2.run_rounds(2)) == _tail(ref_recs[1:])


def test_restore_needs_a_checkpoint_directory():
    svc = _svc("fd")
    with pytest.raises(RuntimeError, match="ckpt_dir"):
        svc.restore()
    with pytest.raises(RuntimeError, match="ckpt_dir"):
        svc.save_checkpoint()


# ---- outages, churn and stragglers ----------------------------------------


def test_service_total_outage_round_records_no_convergence():
    svc = _svc("fd", ch=dict(num_devices=4, theta=1e9))
    svc.trainer.fc.eps = 10.0  # any rel passes: only the gate protects
    recs = svc.run_rounds(3)
    assert [r["uplink_ok"] for r in recs] == [0, 0, 0]
    assert svc.state.converged_round is None


def test_straggler_timeouts_shrink_aggregation_set():
    svc = _svc("fd", ch=dict(CH, compute_mean_s=1.0, deadline_s=0.7))
    recs = svc.run_rounds(3)
    assert sum(r["n_straggle"] for r in recs) > 0
    for r in recs:
        assert r["uplink_ok"] <= 4 - r["n_straggle"]
        assert r["round_latency_s"] >= 0.0


@pytest.mark.parametrize("p_active,min_active,seed,pool", [
    (0.3, 2, 5, 6), (0.6, 2, 3, 4), (0.5, 1, 0, 400), (1.0, 1, 5, 6),
    (1.0 - 1e-9, 1, 5, 6), (0.05, 3, 9, 10)])
def test_churn_draw_is_the_references(p_active, min_active, seed, pool):
    """Bit-equal cohorts, a pure function of (seeds, round), at least
    ``min_active`` devices; the top-up draws from the same generator."""
    ref = load_reference().sampling.ChurnConfig(p_active, min_active, seed)
    churn = ChurnConfig(p_active, min_active, seed)
    draws = set()
    for p in range(1, 30):
        a = churn.active_devices(0, p, pool)
        np.testing.assert_array_equal(a, ref.active_devices(0, p, pool))
        np.testing.assert_array_equal(a, churn.active_devices(0, p, pool))
        assert len(a) >= min(min_active, pool)
        assert len(np.unique(a)) == len(a) and 0 <= a.min() <= a.max() < pool
        draws.add(tuple(a))
    assert len(draws) > 1 or p_active >= 1.0 - 1e-9


def test_full_participation_churn_consumes_the_same_stream():
    full = ChurnConfig(p_active=1.0, min_active=1, seed=5)
    near = ChurnConfig(p_active=1.0 - 1e-9, min_active=1, seed=5)
    for p in range(1, 10):
        a = full.active_devices(0, p, 6)
        np.testing.assert_array_equal(a, np.arange(6))
        np.testing.assert_array_equal(a, near.active_devices(0, p, 6))


def test_churn_and_sampler_streams_compose_without_bias():
    """Churn and client sampling at the same seeds draw from disjoint
    streams: a churn-active device is then sampled at about q."""
    pool, rounds = 400, 200
    churn = ChurnConfig(p_active=0.5, min_active=1, seed=0)
    sampler = SamplerConfig(sample_ratio=0.5, min_active=1, seed=0)
    active = np.zeros(pool, np.int64)
    chosen = np.zeros(pool, np.int64)
    for p in range(1, rounds + 1):
        idx = churn.active_devices(0, p, pool)
        sub = sampler.cohort(0, p, len(idx))
        active[idx] += 1
        chosen[idx[sub]] += 1
    rate = chosen / np.maximum(active, 1)
    assert 0.4 < rate[:100].mean() < 0.6
    assert 0.4 < rate.mean() < 0.6
    assert rate.max() < 0.8


def test_churn_config_validation():
    with pytest.raises(ValueError, match="p_active"):
        ChurnConfig(p_active=0.0)
    with pytest.raises(ValueError, match="min_active"):
        ChurnConfig(min_active=0)


def test_churned_cohort_state_scatters_back_to_pool():
    """Only devices active in a round change their pool state."""
    svc = _svc("fd", churn=dict(p_active=0.5, min_active=2, seed=1))
    before = svc.state.dev_gout.clone()
    w_before = svc.state.dev_params["conv1"]["w"].clone()
    recs = svc.run_rounds(2)
    active = set(recs[0]["active"].tolist()) | set(
        recs[1]["active"].tolist())
    assert 0 < len(recs[1]["active"]) < 4
    changed = {d for d in range(4)
               if not torch.equal(before[d], svc.state.dev_gout[d])}
    trained = {d for d in range(4) if not torch.equal(
        w_before[d], svc.state.dev_params["conv1"]["w"][d])}
    assert changed and trained
    assert changed <= active and trained <= active


def test_config_churn_drives_the_service():
    """``FederatedConfig(churn=...)`` is the service's churn unless one is
    passed explicitly."""
    fc = _cfg("fd", churn=ChurnConfig(**CHURN))
    svc = FederatedService(CNN(), fc, ChannelConfig(**CH), device="cpu")
    assert svc.churn == ChurnConfig(**CHURN)
    other = ChurnConfig(p_active=0.5)
    assert FederatedService(CNN(), fc, ChannelConfig(**CH), churn=other,
                            device="cpu").churn is other


def test_service_refuses_mixed_cohorts():
    with pytest.raises(ValueError, match="homogeneous"):
        FederatedService(None, _cfg("fd", model="cnn+mlp"),
                         ChannelConfig(**CH), device="cpu")


def test_service_requires_bound_data():
    svc = FederatedService(CNN(), _cfg("fd"), ChannelConfig(**CH),
                           device="cpu")
    with pytest.raises(RuntimeError, match="bind_data"):
        svc.step()


def test_bind_data_validates_pool_size():
    svc = FederatedService(CNN(), _cfg("fd", num_devices=7),
                           ChannelConfig(**CH), device="cpu")
    with pytest.raises(ValueError, match="num_devices=7"):
        svc.bind_data(*golden_data())


# ---- the inference endpoint ------------------------------------------------


def _direct(svc, x):
    with torch.no_grad():
        return CNN().apply(svc.state.g_params, torch.as_tensor(x)).argmax(
            -1).numpy()


def test_endpoint_pads_to_fixed_batch_and_matches_direct_apply():
    svc = _svc("fd", serve_batch=8)
    svc.run_rounds(1)
    tx, _ = _test_set()
    preds = svc.serve(tx[:13])          # not a multiple of the batch
    assert preds.shape == (13,)
    np.testing.assert_array_equal(preds, _direct(svc, tx[:13]))
    assert (svc.endpoint.served, svc.endpoint.batches,
            svc.endpoint.pending) == (13, 2, 0)


def test_endpoint_answers_the_references_labels():
    """The same global model answers the same labels in both services."""
    ref = load_reference()
    rsvc = ref.service.FederatedService(
        None, ref.protocols.FederatedConfig(protocol="fd", **GOLDEN_CFG),
        ref.channel.ChannelConfig(**CH), serve_batch=8).bind_data(
            *golden_data())
    rsvc.run_rounds(1)
    svc = _svc("fd", serve_batch=8)
    svc.run_rounds(1)
    tx, _ = _test_set()
    np.testing.assert_array_equal(svc.serve(tx[:40]),
                                  rsvc.serve(tx[:40].numpy()))


def test_endpoint_refuses_a_wrong_request_shape():
    svc = _svc("fd")
    tx, _ = _test_set()
    with pytest.raises(ValueError, match=r"\(28, 28, 1\)"):
        svc.endpoint.submit(tx[:3, :27])
    assert svc.endpoint.pending == 0
    ep = InferenceEndpoint(CNN().apply, 4, device="cpu")
    assert ep.submit(tx[:3]) == 3       # no shape pinned: taken


def test_endpoint_flush_empty_queue_is_noop():
    svc = _svc("fd")
    assert svc.endpoint.flush(svc.state.g_params).shape == (0,)


def test_endpoint_is_separate_from_training_state():
    """Serving between rounds does not perturb training."""
    tx, _ = _test_set()
    a = _svc("fd")
    recs_a = []
    for _ in range(2):
        recs_a.append(a.step())
        a.serve(tx[:4])
    assert _tail(recs_a) == _tail(_svc("fd").run_rounds(2))


def test_flush_requeues_everything_when_predict_fails_mid_loop():
    """A predict that dies on its second batch: no answer left the call,
    so every request of the failed flush stays queued, and the retry
    answers all of them."""
    svc = _svc("fd", serve_batch=4)
    ep = svc.endpoint
    real = ep._predict
    calls = {"n": 0}

    def flaky(params, x):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("backend died")
        return real(params, x)

    ep._predict = flaky
    tx, _ = _test_set()
    ep.submit(tx[:10])                  # 4 + 4 + padded 2
    with pytest.raises(RuntimeError, match="backend died"):
        ep.flush(svc.state.g_params)
    assert ep.pending == 10 and ep.served == 0
    ep._predict = real
    preds = ep.flush(svc.state.g_params)
    np.testing.assert_array_equal(preds, _direct(svc, tx[:10]))
    assert ep.pending == 0 and ep.served == 10


def test_flush_requeues_everything_when_apply_fn_fails():
    def bad_apply(params, x):
        raise ValueError("no such model")

    ep = InferenceEndpoint(bad_apply, batch_size=4, device="cpu")
    tx, _ = _test_set()
    ep.submit(tx[:7])
    with pytest.raises(ValueError, match="no such model"):
        ep.flush(_svc("fd").state.g_params)
    assert ep.pending == 7
    assert ep.served == 0 and ep.batches == 0


def test_flush_requeue_keeps_submission_order():
    svc = _svc("fd", serve_batch=2)
    ep = svc.endpoint
    real = ep._predict
    ep._predict = lambda *a: (_ for _ in ()).throw(RuntimeError("x"))
    tx, _ = _test_set()
    ep.submit(tx[:3])
    with pytest.raises(RuntimeError):
        ep.flush(svc.state.g_params)
    ep.submit(tx[3:5].numpy())
    ep._predict = real
    np.testing.assert_array_equal(ep.flush(svc.state.g_params),
                                  _direct(svc, tx[:5]))


def test_serve_classifier_answers_the_references_labels():
    """The reference's ``serve_classifier`` recipe (its function imports
    the model registry at call time, which C1 breaks outside the loader):
    the registry CNN from PRNGKey(0) behind the endpoint, 40 requests of
    the task's data from PRNGKey(1)."""
    ref = load_reference()
    task = ref.data.parse_task("digits")
    model = ref.model_registry.build_model("cnn", task.input_shape,
                                           task.num_classes)
    ep = ref.service.InferenceEndpoint(model.apply, 16,
                                       input_shape=task.input_shape)
    ep.submit(task.data(jax.random.PRNGKey(1), 40)[0])
    want = ep.flush(model.init(jax.random.PRNGKey(0)))
    lines = []
    got = serve_classifier("cnn", "digits", 16, log=lines.append,
                           device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert "in 3 batches" in lines[1] and "params=12.5K" in lines[0]


# ---- DP accounting through the service -------------------------------------


def test_service_dp_epsilon_composes_over_participation_only():
    """Under 50% churn the busiest device of this seed joins fewer than
    6 rounds, so its epsilon composes over its own rounds."""
    churn = dict(p_active=0.5, min_active=1, seed=3)
    fc_kw = dict(channel=LinkConfig("dp_gaussian", dp_sigma=2.0), max_rounds=6)
    svc = _svc("fd", churn=churn, fc_kw=fc_kw)
    recs = svc.run_rounds(6)
    acct = svc._acct
    assert acct is not None and acct.rounds == 6
    counts = np.zeros(4, np.int64)
    ref = load_reference().sampling.ChurnConfig(**churn)
    for p, r in enumerate(recs, 1):
        np.testing.assert_array_equal(r["active"],
                                      ref.active_devices(0, p, 4))
        counts[r["active"]] += 1
    assert acct.device_rounds == {
        int(d): int(c) for d, c in enumerate(counts) if c}
    assert acct.device_rounds_max() == counts.max() < 6
    assert acct.epsilon_device_max() < acct.epsilon()
    assert recs[-1]["dp_epsilon_device_max"] == acct.epsilon_device_max()
    assert acct.ledger()["sample_ratio"] == pytest.approx(0.5)


def test_checkpoint_roundtrips_device_participation(tmp_path):
    churn = dict(p_active=0.5, min_active=1, seed=3)
    fc_kw = dict(channel=LinkConfig("dp_gaussian", dp_sigma=2.0), max_rounds=6)
    svc = _svc("fd", churn=churn, fc_kw=fc_kw, tmp=tmp_path / "ck")
    svc.run_rounds(3)
    svc2 = _svc("fd", churn=churn, fc_kw=fc_kw, tmp=tmp_path / "ck")
    assert svc2.restore() == 3
    assert svc2._acct.device_rounds == svc._acct.device_rounds
    assert svc2._acct.rounds == 3
    svc.run_rounds(3)
    svc2.run_rounds(3)
    assert svc2._acct.device_rounds == svc._acct.device_rounds
    assert svc2._acct.epsilon_device_max() == \
        svc._acct.epsilon_device_max()


def test_restore_reads_the_older_participation_ledger(tmp_path):
    """Checkpoints written before the dense counts keep a str-keyed
    ``dp_device_rounds`` dict; restore takes it through the accountant's
    ``device_rounds`` setter."""
    churn = dict(p_active=0.5, min_active=1, seed=3)
    fc_kw = dict(channel=LinkConfig("dp_gaussian", dp_sigma=2.0))
    d = str(tmp_path / "ck")
    svc = _svc("fd", churn=churn, fc_kw=fc_kw, tmp=d)
    svc.run_rounds(2)
    tree, meta = ckpt.restore_tree(d)
    meta["dp_device_rounds"] = {str(k): v for k, v in
                                svc._acct.device_rounds.items()}
    del meta["dp_device_counts"]
    ckpt.save(d, 2, tree, meta=meta)
    svc2 = _svc("fd", churn=churn, fc_kw=fc_kw, tmp=d)
    assert svc2.restore() == 2
    assert svc2._acct.device_rounds == svc._acct.device_rounds
    np.testing.assert_array_equal(svc2._acct.device_counts,
                                  svc._acct.device_counts)


# ---- the CLI ---------------------------------------------------------------


def test_cli_trains_serves_and_verifies_the_resume(capsys, tmp_path):
    assert service.main(["--rounds", "4", "--verify-resume", "--device",
                         "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "resume verified: rounds 3..4" in out
    assert "served 16 predictions" in out
    assert ckpt.steps(str(tmp_path)) == [1, 2, 3, 4]
