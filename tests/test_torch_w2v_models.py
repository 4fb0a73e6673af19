"""Skip-gram pairs, SGNS, Item2Vec and DeepWalk of the PyTorch port against
the JAX package, on the CPU.

Both packages build the ``tests/conftest.py`` pure frame; the port starts
from JAX's initial parameters. The negatives' uniforms are JAX's (those of
``jax.random.uniform`` at the key JAX's step uses), fed through the port's
seam ``_uniforms``. Tolerances in float32: skip-gram pairs, DeepWalk's
corpus and the negative-sampling table exact; loss and both tables'
gradients rtol 1e-5, atol 1e-6 (plain indexing and the kernels' plain
versions both); parameters after a fit rtol 1e-4, atol 1e-5; exported
embeddings rtol 1e-5; recommendation ids equal, where two items' scores lie
within 1e-5 relative of each other in either order; predictions after save
and load in the other package 1e-6.
"""
import numpy as np
import pytest
import torch

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.data import DatasetPure
from librecommender_tpu_torch.evaluation import evaluate
from librecommender_tpu_torch.sampling import skipgram_pairs

from tests.test_torch_embed_models import _serve, as_numpy, cols, same_params, same_recs

SMALL = dict(embed_size=8, seed=3)


@pytest.fixture()
def both(pure_frames):
    """(JAX train, JAX info), (port train, port info, port eval)."""
    from librecommender_tpu.data import DatasetPure as JDatasetPure

    train, evals, _ = pure_frames
    j_train, j_info = JDatasetPure.build_trainset(train)
    t_train, t_info = DatasetPure.build_trainset(cols(train))
    return (j_train, j_info), (t_train, t_info, DatasetPure.build_evalset(cols(evals)))


def jax_model(cls, info, **kw):
    import jax

    from librecommender_tpu import models as jmodels

    model = getattr(jmodels, cls)("ranking", info, **{**SMALL, **kw})
    model.build_model()
    return model, jax.device_get(model.params)


def torch_model(cls, info, init=None, device="cpu", **kw):
    model = getattr(tmodels, cls)("ranking", info, device=device, **{**SMALL, **kw})
    if init is not None:
        model.params_from_arrays(init)
    return model


def jax_uniforms(seed, steps, B, S):
    """The uniforms of JAX's SGNS steps ``0 .. steps - 1``."""
    import jax

    base = jax.random.PRNGKey(seed)
    return [np.asarray(jax.random.uniform(jax.random.fold_in(base, i), (B, S)))
            for i in range(steps)]


def feed_uniforms(model, uniforms):
    it = iter(uniforms)

    def pop(shape):
        u = next(it)
        assert u.shape == tuple(shape)
        return torch.tensor(u)

    model._uniforms = pop
    return it


# ------------------------------------------------------------- host parts
@pytest.mark.parametrize("window,max_pairs", [(1, None), (3, None), (9999, None),
                                              (5, 700)])
def test_skipgram_pairs_match_jax(both, window, max_pairs):
    from librecommender_tpu.sampling.skipgram import skipgram_pairs as j_pairs

    _, (_, info, _) = both
    corpus = [list(v) for v in info.user_consumed.values()] + [[3], []]
    got = skipgram_pairs(corpus, window, np.random.default_rng(7), max_pairs)
    want = j_pairs(corpus, window, np.random.default_rng(7), max_pairs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    if max_pairs is not None:
        assert len(got[0]) == max_pairs
    if window == 1:   # neighbours only
        pos = {(int(c), int(x)) for sent in corpus for c, x in zip(sent, sent[1:])}
        assert all((int(a), int(b)) in pos or (int(b), int(a)) in pos
                   for a, b in zip(*got))


@pytest.mark.parametrize("kw", [{}, dict(n_walks=3, walk_length=4, seed=9)])
def test_corpus_matches_jax(both, kw):
    from librecommender_tpu import models as jmodels

    (_, j_info), (_, t_info, _) = both
    for cls in ("DeepWalk", "Item2Vec"):
        if cls == "Item2Vec" and kw:
            continue
        jm = getattr(jmodels, cls)("ranking", j_info, **kw)
        tm = getattr(tmodels, cls)("ranking", t_info, device="cpu", **kw)
        got, want = tm._corpus(), jm._corpus()
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert list(map(int, g)) == list(map(int, w))
    walks = tmodels.DeepWalk("ranking", t_info, device="cpu", **kw)._corpus()
    length = kw.get("walk_length", 10)
    assert all(1 < len(w) <= length for w in walks)


def test_negative_table_matches_jax(both):
    """The float32 cumulative table, and ``searchsorted`` on its left side,
    including a uniform above its last entry (id ``n_items``, the padding
    row)."""
    import jax.numpy as jnp

    (_, j_info), (_, t_info, _) = both
    jm, init = jax_model("Item2Vec", j_info)
    tm = torch_model("Item2Vec", t_info, init)
    cdf = tm._neg_cdf
    assert cdf.dtype == torch.float32
    np.testing.assert_array_equal(cdf.numpy(), np.asarray(jm._neg_cdf))
    u = np.concatenate([np.random.default_rng(0).random(500, dtype=np.float32),
                        cdf.numpy()[:20], [np.nextafter(cdf.numpy()[-1], 2.0)],
                        [0.0]]).astype(np.float32)
    got = torch.searchsorted(cdf, torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.searchsorted(jm._neg_cdf, u)))
    if cdf[-1] < 1.0:
        assert got[-2] == t_info.n_items
    assert tm.net["context_embed"].shape[0] > t_info.n_items


# ------------------------------------------------------------ loss, fit
@pytest.mark.parametrize("cls,kw,tail", [
    ("Item2Vec", {}, False), ("DeepWalk", dict(num_neg=3), False),
    ("Item2Vec", dict(num_neg=1, window_size=2), False), ("Item2Vec", {}, True)])
def test_sgns_loss_and_gradients_match_jax(both, monkeypatch, cls, kw, tail):
    """``tail``: the table's last entry below 1 (float32 rounding leaves it
    so on some data; here both tables are scaled by 0.999) and a tenth of
    the uniforms above it, so their negatives are the padding row
    ``n_items``, in both packages."""
    import jax
    import jax.numpy as jnp

    (_, j_info), (_, t_info, _) = both
    jm, init = jax_model(cls, j_info, **kw)
    tm = torch_model(cls, t_info, init, **kw)
    same_params(tm.params_to_arrays(), init, rtol=0, atol=0)
    rng = np.random.default_rng(1)
    B = 200
    batch = {"center": rng.integers(0, t_info.n_items, B).astype(np.int32),
             "context": rng.integers(0, t_info.n_items, B).astype(np.int32)}
    key = jax.random.PRNGKey(4)
    u = np.array(jax.random.uniform(key, (B, tm.num_neg)))
    if tail:
        jm._neg_cdf = jm._neg_cdf * np.float32(0.999)
        tm._neg_cdf = tm._neg_cdf * np.float32(0.999)
        np.testing.assert_array_equal(tm._neg_cdf.numpy(), np.asarray(jm._neg_cdf))
        top = tm._neg_cdf.numpy()[-1]
        u.reshape(-1)[::10] = np.nextafter(top, np.float32(2.0))
        monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
    want, grads = jax.value_and_grad(jm.loss_fn)(
        jm.params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    want_g = as_numpy(jax.device_get(grads))
    if tail:
        assert np.abs(want_g["context_embed"][t_info.n_items]).max() > 0
    for use_kernel in (False, True):
        tm._mxu_lookup_force = use_kernel
        feed_uniforms(tm, [u])
        loss = tm.loss_fn(tm.net, {k: torch.from_numpy(v.astype(np.int64))
                                   for k, v in batch.items()})
        got_g = torch.autograd.grad(loss, list(tm.net.values()))
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
        for k, g in zip(tm.net.keys(), got_g):
            np.testing.assert_allclose(g.numpy(), want_g[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k}, table_lookup {use_kernel}")


@pytest.mark.parametrize("cls,kw", [
    ("Item2Vec", dict(batch_size=4096)),
    ("DeepWalk", dict(batch_size=3000, n_walks=2, walk_length=6, num_neg=2)),
])
def test_one_epoch_fit_matches_jax(both, cls, kw):
    """One epoch from the same start with JAX's uniforms: the same pairs,
    permutation and wrap-padded last batch, dense Adam (eps 1e-8)."""
    import jax

    (j_train, j_info), (t_train, t_info, _) = both
    kw = dict(n_epochs=1, **kw)
    jm, init = jax_model(cls, j_info, **kw)
    tm = torch_model(cls, t_info, init, **kw)
    n_pairs = len(tm._skipgram_pairs(tm._corpus(), np.random.default_rng(tm.seed))[0])
    steps = -(-n_pairs // kw["batch_size"])
    rest = feed_uniforms(tm, jax_uniforms(tm.seed, steps, kw["batch_size"],
                                          tm.num_neg))
    jm.fit(j_train, neg_sampling=True, verbose=0)
    tm.fit(t_train, neg_sampling=True, verbose=0)
    assert next(rest, None) is None   # one draw a step, as many steps as JAX
    assert n_pairs % kw["batch_size"] != 0   # the last batch is wrap-padded
    same_params(tm.params_to_arrays(), jax.device_get(jm.params))
    np.testing.assert_allclose(tm.item_embeds_np, jm.item_embeds_np, rtol=1e-4,
                               atol=1e-5)
    assert np.isfinite(tm.trainer.epoch_losses).all()


def test_same_seed_fits_repeat_through_the_kernels_plain_versions(both):
    """Through ``table_lookup`` (the ordered segment-sum on the CPU) two
    same-seed fits are bit-identical."""
    _, (t_train, t_info, _) = both
    runs = []
    for _ in range(2):
        tm = torch_model("Item2Vec", t_info, n_epochs=2, batch_size=4096,
                         window_size=5)
        tm._mxu_lookup_force = True
        tm.fit(t_train, neg_sampling=True, verbose=0)
        runs.append(tm.params_to_arrays())
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k])


# ------------------------------------------------- exports, saves, contract
@pytest.mark.parametrize("cls,kw", [("Item2Vec", {}),
                                    ("DeepWalk", dict(norm_embed=True))])
def test_exported_embeddings_and_recommendations_match_jax(both, cls, kw):
    from librecommender_tpu.utils.save_load import unflatten_tree

    (_, j_info), (_, t_info, _) = both
    jm, init = jax_model(cls, j_info, **kw)
    rng = np.random.default_rng(5)
    init = {k: (v + rng.normal(scale=0.1, size=np.shape(v)).astype(np.float32))
            for k, v in as_numpy(init).items()}
    jm.params = unflatten_tree(init)
    jm.post_fit()
    tm = torch_model(cls, t_info, init, **kw)
    tm.post_fit()
    np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(tm.item_embeds_np, jm.item_embeds_np)
    if kw.get("norm_embed"):
        np.testing.assert_allclose(np.linalg.norm(tm.item_embeds_np[:-1], axis=1), 1.0,
                                   rtol=1e-5)
    for u in (0, 9):
        consumed = t_info.user_consumed[u]
        np.testing.assert_allclose(tm.user_embeds_np[u],
                                   tm.item_embeds_np[consumed].mean(axis=0), rtol=1e-6)
    np.testing.assert_array_equal(tm.default_recs, jm.default_recs)
    raw_users = [int(t_info.id2user[u]) for u in (0, 5, 17)] + [-1]
    for kwargs in ({}, {"filter_consumed": False}):
        want = jm.recommend_user(raw_users, 9, **kwargs)
        have = tm.recommend_user(raw_users, 9, **kwargs)
        for u in raw_users:
            u_vec = tm.user_embeds_np[t_info.user2id.get(u, t_info.n_users)]
            same_recs(have[u], want[u],
                      lambda i: u_vec.astype(np.float64) @ tm.item_embeds_np[
                          t_info.item2id[i]], (u, kwargs))


@pytest.mark.parametrize("cls", ["Item2Vec", "DeepWalk"])
@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_saved_model_loads_in_the_other_package(both, tmp_path, cls, saver):
    import json

    from librecommender_tpu import models as jmodels

    (j_train, j_info), (t_train, t_info, _) = both
    kw = dict(n_epochs=1, window_size=3, n_walks=2) if cls == "DeepWalk" else dict(
        n_epochs=1, window_size=3)
    if saver == "jax":
        src, _ = jax_model(cls, j_info, **kw)
        src.fit(j_train, neg_sampling=True, verbose=0)
        src.save(tmp_path, cls)
        dst = getattr(tmodels, cls).load(tmp_path, cls, device="cpu")
    else:
        src = torch_model(cls, t_info, **kw)
        src.fit(t_train, neg_sampling=True, verbose=0)
        src.save(tmp_path, cls)
        dst = getattr(jmodels, cls).load(tmp_path, cls)
    assert type(dst).__name__ == cls
    users = np.arange(60) % t_info.n_users
    items = (np.arange(60) * 3) % t_info.n_items
    np.testing.assert_allclose(dst.predict(users, items, inner_id=True),
                               src.predict(users, items, inner_id=True), atol=1e-6)
    raw = [int(t_info.id2user[3]), -1]
    want, have = src.recommend_user(raw, 5), dst.recommend_user(raw, 5)
    for u in raw:
        np.testing.assert_array_equal(have[u], want[u])
    if saver == "torch":
        hyper = json.loads((tmp_path / f"{cls}_hyper_params.json").read_text())
        assert "device" not in hyper and hyper["model_class"] == cls
        assert _serve(tmp_path, cls, raw[0]) == [int(i) for i in want[raw[0]]]


def test_constructor_contract(both):
    _, (t_train, t_info, _) = both
    for cls in ("Item2Vec", "DeepWalk"):
        model = getattr(tmodels, cls)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                model("ranking", t_info)   # device=None means the GPU
        m = model("ranking", t_info, device="cpu")
        assert "device" not in m.all_args
        assert (m.lr, m.batch_size, m.num_neg, m.n_epochs) == (0.005, 10000, 5, 5)
        with pytest.raises(ValueError):
            model("rating", t_info, device="cpu")
        with pytest.raises(TypeError):
            m.fit(t_train, neg_sampling=None, verbose=0)
    assert tmodels.Item2Vec("ranking", t_info, device="cpu").window_size == 9999
    assert tmodels.Item2Vec("ranking", t_info, device="cpu",
                            window_size=4).all_args["window_size"] == 4
    deep = tmodels.DeepWalk("ranking", t_info, device="cpu")
    assert (deep.window_size, deep.n_walks, deep.walk_length) == (5, 10, 10)


# ----------------------------------------------------------- slow checks
@pytest.mark.slow
@pytest.mark.parametrize("cls", ["Item2Vec", "DeepWalk"])
def test_two_epoch_fit_matches_jax(both, cls):
    import jax

    (j_train, j_info), (t_train, t_info, _) = both
    kw = dict(n_epochs=2, batch_size=2048, window_size=4)
    jm, init = jax_model(cls, j_info, **kw)
    tm = torch_model(cls, t_info, init, **kw)
    n_pairs = len(tm._skipgram_pairs(tm._corpus(), np.random.default_rng(tm.seed))[0])
    steps = 2 * -(-n_pairs // 2048)
    feed_uniforms(tm, jax_uniforms(tm.seed, steps, 2048, tm.num_neg))
    jm.fit(j_train, neg_sampling=True, verbose=0)
    tm.fit(t_train, neg_sampling=True, verbose=0)
    same_params(tm.params_to_arrays(), jax.device_get(jm.params))
    np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np, rtol=1e-4,
                               atol=1e-5)


# model -> (JAX's AUC on the planted synthetic, PARITY.md:143-144, kwargs as
# parity/run_ours.py:132-136 runs it)
W2V_PARITY = {
    "Item2Vec": (0.7041, dict(n_epochs=2, window_size=5)),
    "DeepWalk": (0.6558, dict(n_epochs=5, n_walks=10, walk_length=10)),
}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(W2V_PARITY))
def test_w2v_model_auc_on_planted_synthetic(name):
    from parity.synthetic import chrono_split, make_ml1m_like

    train, evals = chrono_split(make_ml1m_like())
    keep = ["user", "item", "label", "time"]
    train_data, info = DatasetPure.build_trainset(cols(train[keep]))
    eval_data = DatasetPure.build_evalset(cols(evals[keep]))
    want, kw = W2V_PARITY[name]
    model = getattr(tmodels, name)("ranking", info, embed_size=32, device="cpu", **kw)
    model.fit(train_data, neg_sampling=True, verbose=1)
    res = evaluate(model, eval_data, neg_sampling=True, eval_batch_size=8192, k=10,
                   metrics=["roc_auc", "precision", "recall", "ndcg"], seed=2222)
    print(f"port {name} on the planted synthetic: {res}")
    assert want - 0.01 <= res["roc_auc"] <= want + 0.01
