"""SVD, SVDpp and ALS of the PyTorch port, and the public helpers they use,
against the JAX package on the CPU.

Both packages build the ``tests/conftest.py`` pure frame; the port starts
from JAX's initial parameters, and with ``shuffle=False`` and
``sampler="unconsumed"`` both see the same batches. Tolerances in float32:
scores, loss and every gradient rtol 1e-5 (atol 1e-7 for gradient entries
that are sums of terms cancelling to near zero); SVD's lazy Adam in both
forms over 20 steps rtol 1e-6 (atol 1e-9); ALS after 2 epochs rtol 1e-4,
atol 1e-5; parameters after a 2-epoch fit rtol 1e-4, atol 1e-5;
recommendation ids equal, where two items' scores lie within 1e-5 relative
of each other in either order; predictions after save and load in the other
package 1e-6. ALS's bucket gathers go through ``table_gather``, whose plain
version runs on the CPU; the ``cuda`` test launches the gather kernel.
"""
import numpy as np
import pytest
import torch

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.data import DatasetPure
from librecommender_tpu_torch.evaluation import evaluate

SMALL = dict(embed_size=8, batch_size=256, seed=3)
ALS_SMALL = dict(embed_size=8, seed=3)   # ALS takes no batch size


def small(cls, **kw):
    return {**(ALS_SMALL if cls == "ALS" else SMALL), **kw}
NEAR_TIE = 1e-5


def cols(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


@pytest.fixture()
def both(pure_frames):
    """(JAX train, JAX info), (port train, port info, port eval)."""
    from librecommender_tpu.data import DatasetPure as JDatasetPure

    train, evals, _ = pure_frames
    j_train, j_info = JDatasetPure.build_trainset(train)
    t_train, t_info = DatasetPure.build_trainset(cols(train))
    t_eval = DatasetPure.build_evalset(cols(evals))
    return (j_train, j_info), (t_train, t_info, t_eval)


def jax_model(cls, info, task="ranking", **kw):
    import jax

    from librecommender_tpu import models as jmodels

    model = getattr(jmodels, cls)(task, info, **small(cls, **kw))
    model.build_model()
    return model, jax.device_get(model.params)


def torch_model(cls, info, init=None, task="ranking", device="cpu", **kw):
    model = getattr(tmodels, cls)(task, info, device=device, **small(cls, **kw))
    if init is not None:
        model.params_from_arrays(init)
    return model


def as_numpy(tree):
    from librecommender_tpu_torch.utils.save_load import flatten_tree

    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def jax_params(jm):
    import jax

    return jax.device_get(jm.params)


def same_params(got, want, rtol=1e-4, atol=1e-5):
    want = as_numpy(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def same_recs(have, want, scores, what=""):
    """Equal id lists, but for neighbours whose scores (``scores``: id ->
    score) are within NEAR_TIE relative of each other."""
    have, want = list(have), list(want)
    assert len(have) == len(want), what
    for i, (a, b) in enumerate(zip(have, want)):
        if a != b:
            sa, sb = scores(a), scores(b)
            assert abs(sa - sb) <= NEAR_TIE * max(abs(sa), abs(sb)), (what, i, a, b)


def batch_of(info, train, n=96, num_neg=2, seed=0, labels=None, start=0):
    """Rows ``start:start + n`` of ``train``, a random weight mask and
    ``num_neg`` uniform negatives a row, from ``seed``."""
    rng = np.random.default_rng(seed)
    rows = slice(start, start + n)
    batch = {
        "user": train.user_indices[rows].astype(np.int32),
        "item": train.item_indices[rows].astype(np.int32),
        "label": (np.ones(n, np.float32) if labels is None
                  else labels[rows].astype(np.float32)),
        "weight": (rng.random(n) < 0.9).astype(np.float32),
    }
    if num_neg:
        batch["item_neg"] = rng.integers(0, info.n_items, (n, num_neg)).astype(np.int32)
    return batch


def jax_loss_and_grads(jm, batch):
    import jax
    import jax.numpy as jnp

    loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jm.params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    return float(loss), as_numpy(jax.device_get(grads))


def torch_loss_and_grads(tm, batch):
    loss = tm.loss_fn(tm.net, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tm.net.values()))
    return loss.item(), {k: g.numpy() for k, g in zip(tm.net.keys(), grads)}


# name -> (class, task, kwargs beside SMALL, sampled negatives a row)
LOSS_CASES = {
    "svd": ("SVD", "ranking", {}, 2),
    "svd-focal": ("SVD", "ranking", dict(loss_type="focal"), 1),
    "svd-rating": ("SVD", "rating", {}, 0),
    "svd-norm-reg": ("SVD", "ranking", dict(norm_embed=True, reg=0.01), 2),
    "svdpp-dense": ("SVDpp", "ranking", dict(reg=0.01), 2),
    "svdpp-gather": ("SVDpp", "ranking", dict(reg=0.01, dense_adj_limit=0), 2),
    "svdpp-recent-focal": ("SVDpp", "ranking",
                           dict(recent_num=5, loss_type="focal"), 1),
    "svdpp-gather-rating": ("SVDpp", "rating", dict(dense_adj_limit=0), 0),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_gradients_match_jax(both, case):
    (j_train, j_info), (t_train, t_info, _) = both
    cls, task, kw, num_neg = LOSS_CASES[case]
    jm, init = jax_model(cls, j_info, task, **kw)
    tm = torch_model(cls, t_info, init, task, **kw)
    same_params(tm.params_to_arrays(), init, rtol=0, atol=0)
    if cls == "SVDpp":
        # the same implicit form, from the same neighbour table
        assert (tm.implicit_adj is None) == (jm.implicit_adj is None)
        if tm.implicit_adj is not None:
            np.testing.assert_array_equal(tm.implicit_adj.numpy(),
                                          np.asarray(jm.implicit_adj))
        else:
            np.testing.assert_array_equal(tm.consumed_table.numpy(),
                                          np.asarray(jm.consumed_table))
    labels = t_train.labels if task == "rating" else None
    batch = batch_of(t_info, t_train, num_neg=num_neg, labels=labels)
    j_loss, j_grads = jax_loss_and_grads(jm, batch)
    t_loss, t_grads = torch_loss_and_grads(tm, batch)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    for k, g in j_grads.items():
        np.testing.assert_allclose(t_grads[k], g, rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("mode", ["dense", "rows"])
def test_svd_lazy_adam_matches_jax(both, mode):
    """20 steps of SVD under lazy Adam, each package's update on the same
    batches and the same gradients (the port's; the gradients themselves are
    held to JAX's above). The dense form's touched mask reads the last axis,
    so a 1-D bias table is one row: once any bias is touched, every bias
    with momentum moves, in both packages."""
    import jax.numpy as jnp

    from librecommender_tpu.training import sparse_optim as js
    from librecommender_tpu_torch.training import sparse_optim as ps

    (_, j_info), (t_train, t_info, _) = both
    jm, init = jax_model("SVD", j_info, sparse_optimizer=True)
    tm = torch_model("SVD", t_info, init, sparse_optimizer=True)
    keys = tm.sparse_tables
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = js.init_table_state(j_params, keys)
    t_state = ps.init_table_state(tm.net, keys)
    n = 64
    for step in range(20):
        batch = batch_of(t_info, t_train, n=n, num_neg=1, seed=step,
                         start=step * n)
        j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
        t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        t_loss = tm.loss_fn(tm.net, t_batch)
        t_grads = dict(zip(tm.net.keys(),
                           torch.autograd.grad(t_loss, list(tm.net.values()))))
        j_grads = {k: jnp.asarray(g.numpy()) for k, g in t_grads.items()}
        if mode == "dense":
            new, j_state = js.dense_masked_adam_update(j_params, j_grads, j_state,
                                                       keys, 0.001, eps=1e-5)
            ps.dense_masked_adam_update(tm.net, t_grads, t_state, keys, 0.001,
                                        eps=1e-5)
        else:
            new, j_state = js.lazy_adam_update(
                j_params, j_grads, j_state,
                jm.touched_indices(j_batch), 0.001, eps=1e-5)
            ps.lazy_adam_update(tm.net, t_grads, t_state,
                                tm.touched_indices(t_batch), 0.001, eps=1e-5)
        j_params = {**j_params, **new}
        bias = tm.net["user_bias"].detach().numpy().copy()
        if step == 1:
            # biases with momentum from step 0 that step 1 does not touch:
            # the dense form moves them, the row form does not
            idle = np.setdiff1d(np.flatnonzero(momentum), batch["user"])
            moved = bias[idle] != before[idle]
            assert len(idle) and (moved.all() if mode == "dense" else not moved.any())
        momentum = t_state["mu"]["user_bias"].numpy() != 0
        before = bias
    assert t_state["count"] == int(j_state["count"]) == 20
    got = tm.params_to_arrays()
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(j_params[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)


def moved_start(cls, info, task, init, **kw):
    """A JAX model from ``init`` moved by 1e-7 normal noise: how far JAX's
    own fit spreads float32 rounding."""
    import jax

    jm, _ = jax_model(cls, info, task, **kw)
    noise = np.random.default_rng(0)
    jm.params = jax.tree.map(
        lambda a: a + 1e-7 * noise.standard_normal(a.shape).astype(a.dtype),
        jm.params)
    return jm


def within_spread(got, want, moved, what=""):
    """``got`` no farther from ``want`` than twice ``moved`` is, plus 1e-5,
    by array."""
    assert sorted(got) == sorted(want)
    for k in want:
        limit = 2 * np.abs(moved[k] - want[k]).max() + 1e-5
        assert np.abs(got[k] - want[k]).max() <= limit, (what, k)


# ALS: name -> (task, kwargs beside ALS_SMALL)
ALS_CASES = {
    "implicit": ("ranking", dict(reg=0.1, alpha=10)),
    "explicit": ("rating", dict(reg=0.1)),
}


@pytest.mark.parametrize("case", list(ALS_CASES))
def test_als_matches_jax(both, case, monkeypatch):
    """Two epochs of ALS from JAX's initial tables; every bucket's gather
    goes through ``table_gather`` (its plain version here), one call a bucket
    a side an epoch. The explicit task's solves (ratings up to 5, no
    confidence term) spread float32 rounding: JAX's own fit from its start
    moved by 1e-7 ends 1.2e-4 away (the port 1.3e-4), so it is held to twice
    that distance, plus 1e-5; the implicit task to rtol 1e-4, atol 1e-5."""
    from librecommender_tpu_torch.models import als as talas

    (j_train, j_info), (t_train, t_info, _) = both
    task, kw = ALS_CASES[case]
    kw = dict(n_epochs=2, **kw)
    jm, init = jax_model("ALS", j_info, task, **kw)
    tm = torch_model("ALS", t_info, init, task, **kw)
    calls = []
    plain = talas.table_gather

    def counted(table, ids):
        calls.append(ids.shape[0])
        return plain(table, ids)

    monkeypatch.setattr(talas, "table_gather", counted)
    neg = task == "ranking"
    jm.fit(j_train, neg_sampling=neg, verbose=0)
    tm.fit(t_train, neg_sampling=neg, verbose=0)
    user_buckets, item_buckets = tm.side_buckets(t_train)
    assert len(calls) == 2 * (len(user_buckets) + len(item_buckets))
    users = np.arange(40) % t_info.n_users
    items = (np.arange(40) * 7) % t_info.n_items
    have = tm.predict(users, items, inner_id=True)
    want = jm.predict(users, items, inner_id=True)
    if case == "explicit":
        moved = moved_start("ALS", j_info, task, init, **kw)
        moved.fit(j_train, neg_sampling=neg, verbose=0)
        within_spread(tm.params_to_arrays(), as_numpy(jax_params(jm)),
                      as_numpy(jax_params(moved)))
        assert np.abs(have - want).max() <= 2 * np.abs(
            moved.predict(users, items, inner_id=True) - want).max() + 1e-5
    else:
        same_params(tm.params_to_arrays(), jax_params(jm))
        np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(have, want, rtol=1e-4, atol=1e-5)


# 2-epoch fits: name -> (class, task, kwargs beside SMALL, lazy-Adam form)
FIT_CASES = {
    "svd": ("SVD", "ranking", {}, None),
    "svd-lazy-dense": ("SVD", "ranking", dict(sparse_optimizer=True), "dense"),
    "svd-lazy-rows": ("SVD", "ranking", dict(sparse_optimizer=True), "rows"),
    "svd-rating": ("SVD", "rating", dict(reg=0.01), None),
    "svdpp-dense": ("SVDpp", "ranking", {}, None),
    "svdpp-gather": ("SVDpp", "ranking", dict(dense_adj_limit=0), None),
}


@pytest.mark.slow
@pytest.mark.parametrize("case", list(FIT_CASES))
def test_two_epoch_fit_matches_jax(both, case):
    (j_train, j_info), (t_train, t_info, t_eval) = both
    cls, task, kw, mode = FIT_CASES[case]
    kw = dict(n_epochs=2, lr=0.001, **kw)
    if task == "ranking":
        kw.update(sampler="unconsumed", num_neg=2)
    jm, init = jax_model(cls, j_info, task, **kw)
    tm = torch_model(cls, t_info, init, task, **kw)
    if mode is not None:
        jm.sparse_update_mode = tm.sparse_update_mode = mode
    neg = task == "ranking"
    jm.fit(j_train, neg_sampling=neg, verbose=0, shuffle=False)
    tm.fit(t_train, neg_sampling=neg, verbose=0, shuffle=False)
    got = tm.params_to_arrays()
    for k, v in init.items():   # it trained
        assert not np.allclose(got[k], v, rtol=1e-3, atol=1e-4), k
    same_params(got, jax_params(jm))
    np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np,
                               rtol=1e-4, atol=1e-5)
    assert np.isfinite(tm.trainer.epoch_losses).all()
    metric = "roc_auc" if neg else "rmse"
    res = evaluate(tm, t_eval, neg_sampling=neg, metrics=[metric])
    assert np.isfinite(res[metric])


@pytest.mark.parametrize("cls", ["SVD", "SVDpp", "ALS"])
def test_recommend_ids_match_jax(both, cls):
    """recommend_user from JAX's initial parameters (biases made non-zero):
    the same ids for known users and a cold one, with and without the
    consumed filter, and the same cold-start list."""
    (_, j_info), (_, t_info, _) = both
    raw_users = [int(t_info.id2user[u]) for u in (0, 5, 17, 33)] + [-1]
    jm, init = jax_model(cls, j_info)
    rng = np.random.default_rng(1)
    for k in ("user_bias", "item_bias"):
        if k in init:
            init[k] = rng.normal(scale=0.05, size=init[k].shape).astype(np.float32)
    jm.params = init
    jm.post_fit()
    tm = torch_model(cls, t_info, init)
    tm.post_fit()
    np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(tm.default_recs, jm.default_recs)
    for kwargs in ({}, {"filter_consumed": False}, {"cold_start": "popular"}):
        want = jm.recommend_user(raw_users, 9, **kwargs)
        have = tm.recommend_user(raw_users, 9, **kwargs)
        for u in raw_users:
            uid = t_info.user2id.get(u, t_info.n_users)
            u_vec = tm.user_embeds_np[uid].astype(np.float64)

            def score(item):
                return u_vec @ tm.item_embeds_np[t_info.item2id[item]]

            same_recs(have[u], want[u], score, (u, kwargs))


def _serve(tmp_path, name, user):
    import json
    import threading
    import urllib.request

    from librecommender_tpu_torch.serving import DictStore, create_server

    store = DictStore()
    store.set("model_path", str(tmp_path))
    store.set("model_meta", {"model_name": name})
    server, port = create_server("model", store, port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/model/recommend",
            data=json.dumps({"user": user, "n_rec": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            served = json.loads(resp.read())["rec_list"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return served


SAVE_CASES = {
    "svd": ("SVD", dict(n_epochs=1)),
    "svdpp-dense": ("SVDpp", dict(n_epochs=1)),
    "svdpp-gather": ("SVDpp", dict(n_epochs=1, dense_adj_limit=0)),
    "als": ("ALS", dict(n_epochs=1)),
}


@pytest.mark.parametrize("case", list(SAVE_CASES))
@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_saved_model_loads_in_the_other_package(both, tmp_path, case, saver):
    """A fitted model saved by one package predicts and recommends the same
    in the other; the port's save is served over HTTP by its class name."""
    import json

    from librecommender_tpu import models as jmodels

    (j_train, j_info), (t_train, t_info, _) = both
    cls, kw = SAVE_CASES[case]
    if saver == "jax":
        src, _ = jax_model(cls, j_info, **kw)
        src.fit(j_train, neg_sampling=True, verbose=0)
        src.save(tmp_path, case)
        dst = getattr(tmodels, cls).load(tmp_path, case, device="cpu")
    else:
        src = torch_model(cls, t_info, **kw)
        src.fit(t_train, neg_sampling=True, verbose=0)
        src.save(tmp_path, case)
        dst = getattr(jmodels, cls).load(tmp_path, case)
    assert type(dst).__name__ == cls
    users = np.arange(60) % t_info.n_users
    items = (np.arange(60) * 3) % t_info.n_items
    np.testing.assert_allclose(dst.predict(users, items, inner_id=True),
                               src.predict(users, items, inner_id=True), atol=1e-6)
    raw = [int(t_info.id2user[3]), -1]   # a known user and a cold one
    want, have = src.recommend_user(raw, 5), dst.recommend_user(raw, 5)
    for u in raw:
        np.testing.assert_array_equal(have[u], want[u])
    if saver == "torch":
        hyper = json.loads((tmp_path / f"{case}_hyper_params.json").read_text())
        assert "device" not in hyper and hyper["model_class"] == cls
        assert _serve(tmp_path, case, raw[0]) == [int(i) for i in want[raw[0]]]


def test_constructor_contract(both):
    _, (_, t_info, _) = both
    for cls in ("SVD", "SVDpp", "ALS"):
        model = getattr(tmodels, cls)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                model("ranking", t_info)   # device=None means the GPU
        assert "device" not in model("ranking", t_info, device="cpu").all_args
    for cls in ("SVD", "SVDpp"):
        with pytest.raises(ValueError):
            getattr(tmodels, cls)("ranking", t_info, device="cpu", loss_type="bpr")
    with pytest.raises(ValueError):
        tmodels.SVDpp("ranking", t_info, device="cpu", recent_num=0)
    # the JAX package's defaults
    svdpp = tmodels.SVDpp("ranking", t_info, device="cpu", recent_num=30)
    assert svdpp.max_implicit == 30
    als = tmodels.ALS("ranking", t_info, device="cpu")
    assert (als.reg, als.alpha, als.n_epochs) == (0.01, 10, 10)


# ------------------------------------------------------ public helpers (1.1)
def test_public_helpers_match_jax(both, capsys):
    from librecommender_tpu.recommendation import cold_start_rec as j_cold
    from librecommender_tpu.utils import misc as jmisc
    from librecommender_tpu.utils import validate as jval
    from librecommender_tpu_torch.recommendation import cold_start_rec
    from librecommender_tpu_torch.utils.misc import count_params, time_func
    from librecommender_tpu_torch.utils.validate import (check_unknown,
                                                         check_unknown_user)

    (_, j_info), (_, t_info, _) = both
    jm, init = jax_model("SVD", j_info)
    tm = torch_model("SVD", t_info, init)
    known = int(t_info.id2user[4])
    item = int(t_info.id2item[7])
    assert tm.get_user_id(known) == jm.get_user_id(known) == 4
    assert tm.get_item_id(item) == jm.get_item_id(item) == 7
    for get in (tm.get_user_id, tm.get_item_id):
        with pytest.raises(ValueError, match="unknown"):
            get(-5)
    for users, inner in (([known, -1, int(t_info.id2user[0])], False),
                         ([0, 59, 60, -3], True), (known, False)):
        assert tm.split_cold_users(users, inner) == \
            jval.check_unknown_user(j_info, users, inner)
        assert check_unknown_user(t_info, users, inner) == \
            jval.check_unknown_user(j_info, users, inner)

    class Sizes:
        n_users, n_items = t_info.n_users, t_info.n_items

    user = np.array([0, t_info.n_users, 3, 5])
    item = np.array([t_info.n_items, 1, 2, t_info.n_items])
    got = check_unknown(Sizes, user, item)
    want = jval.check_unknown(Sizes, user, item)
    assert got[:2] == (want[0], [int(i) for i in want[1]]) == (3, [0, 1, 3])

    default = np.array([4, 9, 2, 7])
    for cold, inner in (("average", True), ("average", False),
                        ("popular", True), ("popular", False)):
        got = cold_start_rec(t_info, default, cold, [-1, -2], 3, inner)
        want = j_cold(j_info, default, cold, [-1, -2], 3, inner)
        assert got.keys() == want.keys()
        for u in got:
            np.testing.assert_array_equal(got[u], want[u])
    with pytest.raises(ValueError):
        cold_start_rec(t_info, default, "nearest", [-1], 3, True)

    tm.build_model()
    assert count_params(tm.net) == count_params(tm.params_to_arrays()) \
        == jmisc.count_params(init) == sum(v.size for v in init.values())

    @time_func
    def twice(x):
        return 2 * x

    capsys.readouterr()
    assert twice(21) == 42
    assert "twice elapsed" in capsys.readouterr().out


def test_neighbor_table_matches_jax():
    from librecommender_tpu.graph.adjacency import build_neighbor_table as jtable
    from librecommender_tpu_torch.graph import build_neighbor_table

    rng = np.random.default_rng(4)
    consumed = {u: list(rng.integers(0, 50, rng.integers(1, 40)))
                for u in range(30) if u % 7}
    for width in (5, 16, 64):
        got, want = (f(consumed, 30, width, pad=50)
                     for f in (build_neighbor_table, jtable))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# model -> (JAX's AUC on the planted synthetic, PARITY.md, and the model's
# kwargs as parity/run_ours.py runs it: embed 32, 5 epochs)
EMBED_PARITY = {
    "SVD": (0.6957, dict(lr=0.001, batch_size=2048)),                  # PARITY.md:23
    "SVDpp": (0.7285, dict(lr=0.001, batch_size=2048, recent_num=30)),  # PARITY.md:80
    "ALS": (0.7325, dict(reg=0.1, alpha=10)),                           # PARITY.md:142
}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(EMBED_PARITY))
def test_embed_model_auc_on_planted_synthetic(name):
    """The PARITY.md protocol: ML-1M-sized planted data, chrono split, seed-2222
    eval negatives. The port's draws differ from JAX's (torch generators), so
    each model is held to its JAX column +/- 0.01."""
    from parity.synthetic import chrono_split, make_ml1m_like

    train, evals = chrono_split(make_ml1m_like())
    keep = ["user", "item", "label", "time"]
    train_data, info = DatasetPure.build_trainset(cols(train[keep]))
    eval_data = DatasetPure.build_evalset(cols(evals[keep]))
    want, kw = EMBED_PARITY[name]
    model = getattr(tmodels, name)("ranking", info, embed_size=32, n_epochs=5,
                                   device="cpu", **kw)
    model.fit(train_data, neg_sampling=True, verbose=1, shuffle=True)
    res = evaluate(model, eval_data, neg_sampling=True, eval_batch_size=8192, k=10,
                   metrics=["roc_auc", "precision", "recall", "ndcg"], seed=2222)
    print(f"port {name} on the planted synthetic: {res}")
    assert want - 0.01 <= res["roc_auc"] <= want + 0.01


# ------------------------------------------------------------------- GPU
@pytest.mark.cuda
def test_als_on_gpu_matches_cpu():
    """ALS's bucket gathers on the card: one launch of the gather kernel a
    bucket a side an epoch, and the same solves as on the CPU, from the same
    start, after one user-side pass (rtol 1e-4, atol 1e-5) and after 2
    epochs (the explicit and implicit tasks' AUC and RMSE apart by at most
    1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    from librecommender_tpu_torch.ops import table_gather

    rng = np.random.default_rng(0)
    n = 6000
    data = {"user": rng.integers(0, 300, n), "item": rng.integers(0, 500, n),
            "label": rng.integers(1, 6, n).astype(np.float64)}
    train, info = DatasetPure.build_trainset(data)
    init = tmodels.ALS("ranking", info, embed_size=16, device="cpu")
    init.build_model()
    init = init.params_to_arrays()
    solved = {}
    for device in ("cuda", "cpu"):
        m = tmodels.ALS("ranking", info, embed_size=16, reg=0.1, device=device)
        m.params_from_arrays(init)
        user_buckets, item_buckets = m.side_buckets(train)
        table_gather.reset_launches()
        m.solve_side("user_embed", "item_embed", user_buckets)
        if device == "cuda":
            torch.cuda.synchronize()
            assert table_gather.gather_launches == len(user_buckets)
        solved[device] = m.params_to_arrays()["user_embed"]
    np.testing.assert_allclose(solved["cuda"], solved["cpu"], rtol=1e-4, atol=1e-5)
