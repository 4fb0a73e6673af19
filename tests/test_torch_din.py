"""DIN of the PyTorch port against the JAX package, on the CPU.

Both packages build the ``tests/conftest.py`` feature frame; the port starts
from JAX's initial parameters, and with ``shuffle=False`` and
``sampler="unconsumed"`` both see the same batches. Tolerances: forward and
loss rtol 1e-5; parameters after a 2-epoch fit rtol 1e-4, atol 1e-5 (float32
sums in another order, through Adam); recommendation ids equal; predictions
after save and load in the other package 1e-6. The JAX package's Pallas
scatter runs in interpret mode where its flag is on. The ``cuda`` test runs
the same steps on the card and asserts the scatter kernel's launch count.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from librecommender_tpu_torch.batch.sequence import build_train_seqs
from librecommender_tpu_torch.data import DatasetFeat, TransformedSet
from librecommender_tpu_torch.evaluation import evaluate
from librecommender_tpu_torch.models import DIN
from librecommender_tpu_torch.ops import row_scatter
from librecommender_tpu_torch.serving import DictStore, create_server
from librecommender_tpu_torch.utils.save_load import flatten_tree

FEAT_COLS = dict(user_col=["sex", "age"], item_col=["genre"],
                 sparse_col=["sex", "genre"], dense_col=["age"])
SMALL = dict(embed_size=8, hidden_units=(32, 16), recent_num=5, batch_size=256,
             seed=3)


def as_columns(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


@pytest.fixture()
def both(feat_frames):
    from librecommender_tpu.data import DatasetFeat as JDatasetFeat

    train, evals, _ = feat_frames
    j_train, j_info = JDatasetFeat.build_trainset(train, **FEAT_COLS)
    t_train, t_info = DatasetFeat.build_trainset(as_columns(train), **FEAT_COLS)
    t_eval = DatasetFeat.build_evalset(as_columns(evals))
    return (j_train, j_info), (t_train, t_info, t_eval)


def jax_din(info, **kw):
    import jax

    from librecommender_tpu.models import DIN as JDIN

    model = JDIN("ranking", info, **{**SMALL, **kw})
    model.build_model()
    return model, jax.device_get(model.params)


def torch_din(info, init=None, device="cpu", **kw):
    model = DIN("ranking", info, device=device, **{**SMALL, **kw})
    if init is not None:
        model.params_from_arrays(init)
    return model


def flat_numpy(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def same_params(got, want, rtol=1e-4, atol=1e-5):
    want = flat_numpy(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _batch(info, train, n=96, num_neg=2, seed=0):
    """One training batch from the head of the train set, with all-pad
    histories in it (each user's first interaction)."""
    rng = np.random.default_rng(seed)
    seqs, _ = build_train_seqs(train.user_indices, train.item_indices,
                               info.n_items, 5)
    batch = {
        "user": train.user_indices[:n].astype(np.int32),
        "item": train.item_indices[:n].astype(np.int32),
        "label": np.ones(n, np.float32),
        "weight": (rng.random(n) < 0.9).astype(np.float32),
        "item_neg": rng.integers(0, info.n_items, (n, num_neg)).astype(np.int32),
        "seq": seqs[:n],
    }
    assert (batch["seq"] == info.n_items).all(axis=1).any()
    return batch


@pytest.mark.parametrize("mode", [None, "concat", "elementwise"])
def test_forward_and_loss_match_jax(both, mode):
    import jax
    import jax.numpy as jnp

    (j_train, j_info), (t_train, t_info, _) = both
    jm, init = jax_din(j_info, feat_agg_mode=mode, reg=0.01)
    tm = torch_din(t_info, init, feat_agg_mode=mode, reg=0.01)
    same_params(tm.params_to_arrays(), init, rtol=0, atol=0)
    assert tm.token_dim == jm.token_dim and tm.n_fields == jm.n_fields

    batch = _batch(t_info, t_train)
    inputs = {k: batch[k] for k in ("user", "item", "seq")}
    want = jax.jit(lambda p, i: jm._forward(p, i, train=False, rng=None))(
        jm.params, {k: jnp.asarray(v) for k, v in inputs.items()})
    got = tm._forward(tm._tree(), {k: torch.from_numpy(v) for k, v in inputs.items()},
                      train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)

    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jm.params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for flag in (False, True):   # the scatter-add backward changes nothing
        tm.pallas_grad_scatter = flag
        loss = tm.loss_fn(tm.net, t_batch)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
        grads = dict(zip(tm.net.keys(),
                         torch.autograd.grad(loss, list(tm.net.values()))))
        for k, g in flat_numpy(jax.device_get(j_grads)).items():
            assert torch.isfinite(grads[k]).all(), k   # all-pad histories too
            np.testing.assert_allclose(grads[k].numpy(), g, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_token_table_is_built_once_a_forward(both, monkeypatch):
    _, (t_train, t_info, _) = both
    tm = torch_din(t_info, feat_agg_mode="concat")
    tm.build_model()
    calls = []
    raw = tm._token_embeds_raw
    monkeypatch.setattr(tm, "_token_embeds_raw",
                        lambda p, ids: calls.append(tuple(ids.shape)) or raw(p, ids))
    batch = {k: torch.from_numpy(v) for k, v in _batch(t_info, t_train).items()}
    tm.loss_fn(tm.net, batch)
    assert calls == [(t_info.n_items + 1,)]   # history and targets share it
    assert tm._token_table(tm._tree()).shape == (-(-(t_info.n_items + 1) // 8) * 8,
                                                 tm.token_dim)
    tm.token_pack_max_items = 10   # beyond the cap: assembled per id
    calls.clear()
    tm.loss_fn(tm.net, batch)
    assert len(calls) == 2 and tm._token_table(tm._tree()) is None


# (pallas_grad_scatter, sparse_optimizer, feat_agg_mode, kernel lookups forced)
FITS = [(True, False, None, False), (False, True, None, False),
        (True, True, "concat", True)]


@pytest.mark.parametrize("flag,sparse_optimizer,mode,force", FITS)
def test_two_epoch_fit_matches_jax(both, monkeypatch, flag, sparse_optimizer,
                                   mode, force):
    import jax

    from librecommender_tpu.ops import pallas_scatter as ps

    monkeypatch.setattr(ps, "_INTERPRET", True)
    (j_train, j_info), (t_train, t_info, t_eval) = both
    kw = dict(n_epochs=2, sampler="unconsumed", num_neg=2, feat_agg_mode=mode,
              sparse_optimizer=sparse_optimizer, lr=0.01)
    jm, init = jax_din(j_info, **kw)
    tm = torch_din(t_info, init, **kw)
    jm.pallas_grad_scatter = tm.pallas_grad_scatter = flag
    if force:   # lookups through TableGather (its plain versions here)
        tm._mxu_lookup_force = True
    jm.fit(j_train, neg_sampling=True, verbose=0, shuffle=False)
    tm.fit(t_train, neg_sampling=True, verbose=0, shuffle=False)
    got = tm.params_to_arrays()
    same_params(got, jax.device_get(jm.params))
    assert all(np.isfinite(v).all() for v in got.values())
    assert np.isfinite(tm.trainer.epoch_losses).all()
    assert tm._mxu_lookup is False   # off again after the fit

    users = np.arange(40) % t_info.n_users
    items = (np.arange(40) * 7) % t_info.n_items
    np.testing.assert_allclose(tm.predict(users, items, inner_id=True),
                               jm.predict(users, items, inner_id=True),
                               rtol=1e-4, atol=1e-5)
    raw_users = [int(t_info.id2user[u]) for u in (0, 5, 17)] + [-1]  # and a cold one
    for kwargs in ({}, {"filter_consumed": False}, {"cold_start": "popular"},
                   {"users_per_call": 2}):
        want = jm.recommend_user(raw_users, 7, **kwargs)
        have = tm.recommend_user(raw_users, 7, **kwargs)
        for u in raw_users:
            np.testing.assert_array_equal(have[u], want[u])
    np.testing.assert_array_equal(tm.default_recs, jm.default_recs)
    metrics = evaluate(tm, t_eval, neg_sampling=True, metrics=["roc_auc", "precision"])
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_saved_din_loads_in_the_other_package(both, tmp_path, saver):
    from librecommender_tpu.models import DIN as JDIN

    (j_train, j_info), (t_train, t_info, _) = both
    kw = dict(n_epochs=1, feat_agg_mode="elementwise", dropout_rate=0.0)
    if saver == "jax":
        src, _ = jax_din(j_info, **kw)
        src.fit(j_train, neg_sampling=True, verbose=0)
        src.save(tmp_path, "din")
        dst = DIN.load(tmp_path, "din", device="cpu")
    else:
        src = torch_din(t_info, **kw)
        src.fit(t_train, neg_sampling=True, verbose=0)
        src.save(tmp_path, "din")
        dst = JDIN.load(tmp_path, "din")
    assert dst.hidden_units == (32, 16) and dst.feat_agg_mode == "elementwise"
    users = np.arange(60) % t_info.n_users
    items = (np.arange(60) * 3) % t_info.n_items
    np.testing.assert_allclose(dst.predict(users, items, inner_id=True),
                               src.predict(users, items, inner_id=True), atol=1e-6)
    raw = [int(t_info.id2user[3]), -1]   # a known user and a cold one
    want, have = src.recommend_user(raw, 5), dst.recommend_user(raw, 5)
    for u in raw:
        np.testing.assert_array_equal(have[u], want[u])
    if saver == "torch":
        hyper = json.loads((tmp_path / "din_hyper_params.json").read_text())
        assert "device" not in hyper and hyper["model_class"] == "DIN"
        # and the port's HTTP server serves it by its saved class name
        store = DictStore()
        store.set("model_path", str(tmp_path))
        store.set("model_meta", {"model_name": "din"})
        server, port = create_server("model", store, port=0, device="cpu")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/model/recommend",
                data=json.dumps({"user": raw[0], "n_rec": 5}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                served = json.loads(resp.read())["rec_list"]
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        assert not thread.is_alive()
        assert served == [int(i) for i in want[raw[0]]]


def test_params_from_other_hyper_params_are_refused(both):
    _, (_, t_info, _) = both
    src = torch_din(t_info)
    src.build_model()
    arrays = src.params_to_arrays()
    with pytest.raises(ValueError, match="shape"):
        torch_din(t_info, embed_size=4).params_from_arrays(arrays)
    with pytest.raises(ValueError, match="keys"):
        torch_din(t_info, feat_agg_mode="elementwise").params_from_arrays(arrays)


def test_same_seed_fits_repeat_and_dropout_draws(both):
    _, (t_train, t_info, _) = both

    def fit(**kw):
        m = torch_din(t_info, n_epochs=1, **kw)
        m.pallas_grad_scatter = True
        m.fit(t_train, neg_sampling=True, verbose=0)
        return m.params_to_arrays()

    a, b = fit(dropout_rate=0.2), fit(dropout_rate=0.2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    c = fit()
    assert any(not np.array_equal(a[k], c[k]) for k in a)


def test_early_stopping_keeps_the_nested_parameters(both):
    _, (t_train, t_info, t_eval) = both
    m = torch_din(t_info, n_epochs=3, lr=0.01)
    m.fit(t_train, neg_sampling=True, verbose=0, eval_data=t_eval,
          metrics=["roc_auc"], early_stopping=1)
    assert len(m.trainer.epoch_losses) <= 3
    assert sorted(m.params_to_arrays()) == sorted(m.net.keys())
    assert np.isfinite(m.predict(0, 0, inner_id=True))


def test_constructor_contract(both):
    _, (_, t_info, _) = both
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            DIN("ranking", t_info)   # device=None means the GPU
    with pytest.raises(ValueError):
        torch_din(t_info, feat_agg_mode="sum")
    with pytest.raises(ValueError):
        torch_din(t_info, loss_type="bpr")
    with pytest.warns(UserWarning):
        torch_din(t_info, use_tf_attention=True)
    m = torch_din(t_info, random_num=4, recent_num=None)
    assert (m.seq_mode, m.max_seq_len) == ("random", 4)
    m.build_model()
    # the request-time paths (tests/test_torch_dynamic.py holds them to JAX)
    assert isinstance(m.predict(0, 0, inner_id=True, feats={"sex": "m"}), float)
    assert len(m.recommend_user(0, 3, inner_id=True, seq=[1, 2])[0]) == 3
    m._sync_feature_tables()


def test_recommend_halves_the_user_chunk_when_memory_runs_out(both, monkeypatch):
    _, (_, t_info, _) = both
    m = torch_din(t_info)
    m.build_model()
    users = list(range(9))
    want = m.recommend_user(users, 5, inner_id=True)
    score, calls = m._score_users, []

    def short_of_memory(uids, overrides=None):
        calls.append(len(uids))
        if len(uids) > 2:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return score(uids, overrides)

    monkeypatch.setattr(m, "_score_users", short_of_memory)
    have = m.recommend_user(users, 5, inner_id=True)
    for u in users:
        np.testing.assert_array_equal(have[u], want[u])
    assert calls[:3] == [9, 4, 2] and m._users_per_call_cap == 2
    calls.clear()
    m.recommend_user(users[:4], 5, inner_id=True)   # the cap is remembered
    assert calls == [2, 2]
    with pytest.raises(ValueError):
        m.recommend_user(users, 5, inner_id=True, users_per_call=0)


def test_auto_gate_takes_the_kernel_path_by_ids_per_row(both, monkeypatch):
    _, (t_train, t_info, _) = both
    m = torch_din(t_info)
    m.build_model()
    m.pallas_grad_scatter = "auto"
    seen = []
    monkeypatch.setattr("librecommender_tpu_torch.bases.seq_base.gather_rows",
                        lambda table, ids: seen.append(ids.numel()) or table[ids])
    table = m.net["item_embed"]
    m._grad_aware_gather(table, torch.zeros(table.shape[0] * 4, dtype=torch.int64))
    m._grad_aware_gather(table, torch.zeros(table.shape[0] * 4 - 1, dtype=torch.int64))
    assert seen == [table.shape[0] * 4]


# ------------------------------------------------------------------- GPU
@pytest.mark.cuda
@pytest.mark.parametrize("mode", [None, "concat"])
def test_din_steps_on_gpu_match_cpu(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    rng = np.random.default_rng(0)
    n = 6000
    users, items = rng.integers(0, 80, n), rng.integers(0, 300, n)
    data = {"user": users, "item": items, "label": np.ones(n),
            "sex": np.array(["m", "f"])[users % 2], "age": (users % 7) / 7.0,
            "genre": np.array(list("abcd"))[items % 4]}
    train, info = DatasetFeat.build_trainset(data, **FEAT_COLS)
    head = TransformedSet(train.user_indices[:2048], train.item_indices[:2048],
                          train.labels[:2048])
    init = torch_din(info, feat_agg_mode=mode)
    init.build_model()
    init = init.params_to_arrays()
    fitted = {}
    for device in ("cuda", "cpu"):
        m = torch_din(info, init, device=device, n_epochs=1, batch_size=512,
                      sampler="unconsumed", feat_agg_mode=mode)
        m.pallas_grad_scatter = True
        before = row_scatter.launches
        m.fit(head, neg_sampling=True, verbose=0, shuffle=False)
        if device == "cuda":
            torch.cuda.synchronize()
            steps = -(-2048 // 256)
            assert row_scatter.launches - before == (3 if mode else 2) * steps
        fitted[device] = m.params_to_arrays()
    for k in fitted["cpu"]:
        np.testing.assert_allclose(fitted["cuda"][k], fitted["cpu"][k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
