"""The listwise losses, YouTubeRetrieval and TwoTower of the PyTorch port
against the JAX package, on the CPU.

Losses: the same inputs from a seed through both packages, value and
gradient rtol 1e-5 (atol 1e-7), rows whose every other candidate is masked
included. Models: both build the ``tests/conftest.py`` feature frame or the
multi-sparse frame of ``tests/test_torch_feat_data.py``; the port starts from
JAX's initial parameters. The draws of a loss (YouTubeRetrieval's shared
negatives, TwoTower's SSL field masks) are JAX's, fed through the port's
seams (``_shared_negatives``, ``_ssl_masks``). Tolerances in float32: user
representations, loss and every gradient rtol 1e-5 (atol 1e-6: layer-normed
MLPs and gradient entries that cancel to near zero); lazy Adam
over 20 steps rtol 1e-6; parameters after a 2-epoch fit rtol 1e-4, atol
1e-5; ``compute_dtype="bf16"`` no farther from JAX's float32 than twice
JAX's own bfloat16 is; recommendation ids equal, where two items' scores lie
within 1e-5 relative of each other in either order; predictions after save
and load in the other package 1e-6. Dropout above 0 is held in distribution
only.
"""
import numpy as np
import pytest
import torch

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.evaluation import evaluate
from librecommender_tpu_torch.ops import losses as tl
from librecommender_tpu_torch.models.two_tower import cfm_field_order, mutual_info_score

from tests.test_torch_embed_models import _serve, same_recs, within_spread
from tests.test_torch_feat_models import build_both, flat_numpy, same_params

SMALL = dict(embed_size=8, batch_size=256, seed=3, hidden_units=(16, 8))


def _jax_losses():
    from librecommender_tpu.ops import losses as jl

    return jl


def _hold_loss(name, arrays, kwargs, int_keys=()):
    """Value and the gradient of every float input of one loss, both
    packages."""
    import jax
    import jax.numpy as jnp

    jl = _jax_losses()
    floats = [k for k in arrays if k not in int_keys and arrays[k] is not None]

    def j_loss(*vals):
        kw = {k: jnp.asarray(v) if v is not None else None for k, v in arrays.items()}
        kw.update(zip(floats, vals))
        return getattr(jl, name)(**kw, **kwargs)

    want, want_g = jax.value_and_grad(j_loss, argnums=tuple(range(len(floats))))(
        *[jnp.asarray(arrays[k]) for k in floats])
    t_in = {k: (None if v is None else torch.tensor(v, requires_grad=k in floats))
            for k, v in arrays.items()}
    got = getattr(tl, name)(**t_in, **kwargs)
    grads = torch.autograd.grad(got, [t_in[k] for k in floats])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert np.isfinite(got.item())
    for k, g, w in zip(floats, grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def _embeds(rng, *shape):
    return rng.normal(scale=0.5, size=shape).astype(np.float32)


SOFTMAX_CASES = {
    "plain": dict(),
    "correction-temperature": dict(correction=True, temperature=0.3),
    "hits": dict(hits=True, correction=True),
    "padded": dict(padded=True, correction=True, hits=True),
    # every column of every row is the row's own item: nothing but masked
    # entries in each denominator
    "all-masked": dict(all_same=True, hits=True, padded=True),
}


@pytest.mark.parametrize("case", list(SOFTMAX_CASES))
def test_softmax_cross_entropy_matches_jax(case):
    cfg = SOFTMAX_CASES[case]
    rng = np.random.default_rng(0)
    B, D = 24, 6
    ids = rng.integers(0, 9, B).astype(np.int32)
    if cfg.get("all_same"):
        ids[:] = 4
    weight = np.ones(B, np.float32)
    if cfg.get("padded"):
        weight[-5:] = 0.0
    arrays = dict(
        user_embeds=_embeds(rng, B, D), item_embeds=_embeds(rng, B, D),
        weight=weight, item_ids=ids,
        correction_probs=(rng.uniform(0.0, 0.2, B).astype(np.float32)
                          if cfg.get("correction") else None))
    if arrays["correction_probs"] is not None:
        arrays["correction_probs"][0] = 0.0   # clipped to 1e-8
    _hold_loss("softmax_cross_entropy_loss", arrays,
               dict(temperature=cfg.get("temperature", 1.0),
                    remove_accidental_hits=cfg.get("hits", False)),
               int_keys=("weight", "item_ids", "correction_probs"))


@pytest.mark.parametrize("name", ["sampled_softmax_loss", "nce_loss"])
@pytest.mark.parametrize("case", ["hits", "all-hits", "padded"])
def test_shared_candidate_losses_match_jax(name, case):
    rng = np.random.default_rng(1)
    B, S, N, D = 20, 12, 15, 5
    pos = rng.integers(0, N, B).astype(np.int32)
    neg = rng.integers(0, N, S).astype(np.int32)
    if case == "all-hits":   # row 0's candidates are all its positive
        neg[:] = pos[0]
    weight = np.ones(B, np.float32)
    if case == "padded":
        weight[-4:] = 0.0
    arrays = dict(user_embeds=_embeds(rng, B, D), item_weights=_embeds(rng, N, D),
                  item_biases=_embeds(rng, N), pos_items=pos, neg_items=neg,
                  weight=weight)
    _hold_loss(name, arrays, {}, int_keys=("pos_items", "neg_items", "weight"))


def test_ssl_loss_matches_jax():
    rng = np.random.default_rng(2)
    v1 = _embeds(rng, 16, 6)
    # a view of norm below 1e-8: the norm's clip (at exactly zero JAX's
    # gradient is NaN, the port's finite)
    v1[3] *= 1e-10
    _hold_loss("ssl_loss", dict(view1_embeds=v1, view2_embeds=_embeds(rng, 16, 6)),
               dict(temperature=0.1))
    assert tl.LISTWISE_LOSSES == _jax_losses().LISTWISE_LOSSES


def test_new_initializers_in_distribution():
    from librecommender_tpu_torch.ops import initializers as ti

    gen = torch.Generator().manual_seed(0)
    x = ti.xavier_init(gen, (400, 300), 400, 300)
    scale = (2.0 / 700) ** 0.5
    assert x.abs().max() <= 2 * scale
    # a normal truncated at 2 sigma keeps 0.88 of its standard deviation
    assert abs(float(x.std()) / scale - 0.8796) < 0.01
    u = ti.glorot_uniform(gen, (400, 300), 400, 300)
    limit = (6.0 / 700) ** 0.5
    assert u.abs().max() <= limit and abs(float(u.std()) - limit / 3 ** 0.5) < 0.01 * limit
    z = ti.zeros((3, 2))
    assert z.dtype == torch.float32 and not z.any()


# ------------------------------------------------------------ the models
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


def _batch(train, n=96, num_neg=0, seed=0, n_items=None, start=0):
    rng = np.random.default_rng(seed)
    rows = slice(start, start + n)
    batch = {
        "user": train.user_indices[rows].astype(np.int32),
        "item": train.item_indices[rows].astype(np.int32),
        "label": np.ones(n, np.float32),
        "weight": (rng.random(n) < 0.9).astype(np.float32),
    }
    if num_neg:
        batch["item_neg"] = rng.integers(0, n_items, (n, num_neg)).astype(np.int32)
    return batch


def jax_grads(jm, batch):
    import jax
    import jax.numpy as jnp

    loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jm.params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    return float(loss), flat_numpy(jax.device_get(grads))


def torch_grads(tm, batch):
    loss = tm.loss_fn(tm.net, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tm.net.values()), materialize_grads=True)
    return loss.item(), {k: g.numpy() for k, g in zip(tm.net.keys(), grads)}


def hold_grads(jm, tm, batch):
    j_loss, j_grads = jax_grads(jm, batch)
    t_loss, t_grads = torch_grads(tm, batch)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    assert sorted(t_grads) == sorted(j_grads)
    for k, g in j_grads.items():
        np.testing.assert_allclose(t_grads[k], g, rtol=1e-5, atol=1e-6, err_msg=k)
    return t_loss


def jax_negatives(n_sampled, n_items):
    """The negatives JAX's YouTubeRetrieval draws under ``jax_grads``' key."""
    import jax

    _, r2 = jax.random.split(jax.random.PRNGKey(0))
    return np.asarray(jax.random.randint(r2, (n_sampled,), 0, n_items, dtype="int32"))


def jax_ssl_masks(jm, F, key=None):
    """The field masks JAX's TwoTower draws under ``key`` (``jax_grads``'
    by default), as its ``_ssl_term`` draws them."""
    import jax
    import jax.numpy as jnp

    r1, r2, _ = jax.random.split(jax.random.PRNGKey(0) if key is None else key, 3)
    half = F // 2 if F > 1 else 1
    zeros = jnp.zeros((F,), bool)
    if jm.ssl_pattern == "cfm":
        seed_field = jax.random.randint(r1, (), 0, F)
        view1 = zeros.at[jm.cfm_order[seed_field][:half]].set(True).at[seed_field].set(True)
    else:
        view1 = zeros.at[jax.random.permutation(r1, F)[:half]].set(True)
    if jm.ssl_pattern == "rfm":
        view2 = zeros.at[jax.random.permutation(r2, F)[:half]].set(True)
    else:
        view2 = ~view1
    return np.asarray(view1), np.asarray(view2)


def feed_jax_draws(jm, tm, batch=None, key=None):
    """The port's seams return JAX's draws."""
    if isinstance(tm, tmodels.YouTubeRetrieval):
        def negatives(n):
            return torch.from_numpy(jax_negatives(n, tm.n_items)).long()

        tm._shared_negatives = negatives
    elif tm.ssl_pattern is not None:
        masks = jax_ssl_masks(jm, len(tm.feats.item_sparse_pos), key)
        tm._ssl_masks = lambda F: tuple(torch.from_numpy(m.copy()) for m in masks)


# (class, frame, kwargs beside SMALL, sampled negatives a row)
RETRIEVAL_CASES = {
    "ytr-sampled-softmax": ("YouTubeRetrieval", "conftest", {}, 0),
    "ytr-nce": ("YouTubeRetrieval", "conftest", dict(loss_type="nce"), 0),
    "ytr-few-negatives-norm": ("YouTubeRetrieval", "multi_sparse",
                               dict(num_sampled_per_batch=7, norm_embed=True,
                                    use_bn=False), 0),
    "tt-softmax": ("TwoTower", "conftest", {}, 0),
    "tt-softmax-hits-t": ("TwoTower", "multi_sparse",
                          dict(remove_accidental_hits=True, temperature=0.2,
                               use_correction=False, norm_embed=True), 0),
    "tt-cross-entropy": ("TwoTower", "conftest",
                         dict(loss_type="cross_entropy", reg=0.01), 2),
    "tt-max-margin": ("TwoTower", "multi_sparse",
                      dict(loss_type="max_margin", margin=0.5), 2),
    "tt-rfm": ("TwoTower", "multi_sparse", dict(ssl_pattern="rfm"), 0),
    "tt-rfm-complementary": ("TwoTower", "multi_sparse",
                             dict(ssl_pattern="rfm-complementary",
                                  multi_sparse_combiner="mean"), 0),
    "tt-cfm": ("TwoTower", "multi_sparse", dict(ssl_pattern="cfm", alpha=0.5), 0),
}


@pytest.mark.parametrize("case", list(RETRIEVAL_CASES))
def test_loss_and_gradients_match_jax(feat_frames, case):
    import jax.numpy as jnp

    cls, kind, kw, num_neg = RETRIEVAL_CASES[case]
    (j_train, j_info), (t_train, t_info, _) = build_both(kind, feat_frames)
    jm, init = jax_model(cls, j_info, **kw)
    tm = torch_model(cls, t_info, init, **kw)
    same_params(tm.params_to_arrays(), init, rtol=0, atol=0)
    assert tm.paradigm == jm.paradigm
    batch = _batch(t_train, num_neg=num_neg, n_items=t_info.n_items)
    if cls == "YouTubeRetrieval":
        seqs = tm.batch_extras(t_train)["seq"]
        np.testing.assert_array_equal(seqs, jm.batch_extras(j_train)["seq"])
        batch["seq"] = seqs[: len(batch["user"])]
        want = jm._user_repr(jm.params, jnp.asarray(batch["user"]),
                             jnp.asarray(batch["seq"]), False, None)
        got = tm._user_repr(tm._tree(), torch.from_numpy(batch["user"]),
                            torch.from_numpy(batch["seq"]), False)
    else:
        want = jm.user_tower(jm.params, jnp.asarray(batch["user"]))
        got = tm.user_tower(tm._tree(), torch.from_numpy(batch["user"]))
        if tm.ssl_pattern is not None:
            np.testing.assert_array_equal(tm.item_field_oov.numpy(),
                                          np.asarray(jm.item_field_oov))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    feed_jax_draws(jm, tm)
    hold_grads(jm, tm, batch)


def test_mutual_information_copy_and_cfm_order(feat_frames):
    """The MI copy is bit-equal to scikit-learn's on label arrays with
    independent, dependent and constant columns; cfm's field order is JAX's
    on both frames (the conftest one has a single item field)."""
    from sklearn.metrics import mutual_info_score as sk_mi

    rng = np.random.default_rng(3)
    a = rng.integers(0, 5, 300)
    cases = [(a, rng.integers(0, 7, 300)), (a, (a * 3 + rng.integers(0, 2, 300)) % 4),
             (a, np.zeros(300, int)), (a, a), (np.array(list("xyzxy")), np.arange(5))]
    for x, y in cases:
        assert mutual_info_score(x, y) == sk_mi(x, y)
    table = rng.integers(0, 4, (50, 5))
    table[:, 3] = table[:, 1]
    order = cfm_field_order(table)
    assert order[1][0] == 3 and order[3][0] == 1
    for kind in ("conftest", "multi_sparse"):
        (_, j_info), (_, t_info, _) = build_both(kind, feat_frames)
        jm, _ = jax_model("TwoTower", j_info, ssl_pattern="cfm")
        tm = torch_model("TwoTower", t_info, ssl_pattern="cfm")
        tm.build_model()
        np.testing.assert_array_equal(tm.cfm_order.numpy(), np.asarray(jm.cfm_order))


def test_ssl_masks_in_distribution(feat_frames):
    """The port's own masks: rfm masks two independent halves, the
    complementary pattern the rest, cfm the seed field and the half most
    informative of it; each field is masked about equally often."""
    _, (_, t_info, _) = build_both("multi_sparse", feat_frames)
    F = 4
    for pattern in ("rfm", "rfm-complementary", "cfm"):
        tm = torch_model("TwoTower", t_info, ssl_pattern=pattern)
        tm.build_model()
        counts = np.zeros(F)
        for _ in range(400):
            v1, v2 = (m.numpy() for m in tm._ssl_masks(F))
            if pattern == "cfm":
                assert 2 <= v1.sum() <= 3
            else:
                assert v1.sum() == 2
            if pattern == "rfm":
                assert v2.sum() == 2
            else:
                np.testing.assert_array_equal(v2, ~v1)
            counts += v1
        if pattern != "cfm":
            assert np.all(np.abs(counts / 400 - 0.5) < 0.1), counts


def test_two_tower_lazy_adam_matches_jax(feat_frames):
    """20 steps of TwoTower with SSL under lazy Adam's row form: the touched
    rows (each item field's OOV row among them) are JAX's, and each package's
    update on the port's gradients lands within rtol 1e-6."""
    import jax.numpy as jnp

    from librecommender_tpu.training import sparse_optim as js
    from librecommender_tpu_torch.training import sparse_optim as ps

    (_, j_info), (t_train, t_info, _) = build_both("multi_sparse", feat_frames)
    kw = dict(sparse_optimizer=True, ssl_pattern="rfm-complementary")
    jm, init = jax_model("TwoTower", j_info, **kw)
    tm = torch_model("TwoTower", t_info, init, **kw)
    keys = tm.sparse_tables
    assert keys == jm.sparse_tables == ("user_embed", "item_embed", "sparse_embed")
    j_params = {k: jnp.asarray(v) for k, v in flat_numpy(init).items()}
    j_state = js.init_table_state(j_params, keys)
    t_state = ps.init_table_state(tm.net, keys)
    n = 24
    for step in range(20):
        batch = _batch(t_train, n=n, seed=step, start=step * n)
        t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, t_grads = torch_grads(tm, batch)
        t_grads = {k: torch.from_numpy(g) for k, g in t_grads.items()}
        j_touched = jm.touched_indices({k: jnp.asarray(v) for k, v in batch.items()})
        t_touched = tm.touched_indices(t_batch)
        for k in keys:
            np.testing.assert_array_equal(t_touched[k].numpy(), np.asarray(j_touched[k]))
        new, j_state = js.lazy_adam_update(
            j_params, {k: jnp.asarray(g.numpy()) for k, g in t_grads.items()},
            j_state, j_touched, 0.001, eps=1e-5)
        ps.lazy_adam_update(tm.net, t_grads, t_state,
                            {k: t_touched[k] for k in keys}, 0.001, eps=1e-5)
        j_params = {**j_params, **new}
    got = tm.params_to_arrays()
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(j_params[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)


def test_two_tower_bf16_within_twice_jax_distance(feat_frames):
    """``compute_dtype="bf16"``: towers, loss and gradients no farther from
    JAX's float32 than twice JAX's own bfloat16 is (plus 1e-6)."""
    (_, j_info), (t_train, t_info, _) = build_both("multi_sparse", feat_frames)
    kw = dict(compute_dtype="bf16", ssl_pattern="cfm")
    j16, init = jax_model("TwoTower", j_info, **kw)
    j32, _ = jax_model("TwoTower", j_info, **{**kw, "compute_dtype": "f32"})
    j32.params = j16.params
    tm = torch_model("TwoTower", t_info, init, **kw)
    feed_jax_draws(j16, tm)
    batch = _batch(t_train)
    l16, g16 = jax_grads(j16, batch)
    l32, g32 = jax_grads(j32, batch)
    t_loss, t_grads = torch_grads(tm, batch)
    assert abs(t_loss - l32) <= 2 * abs(l16 - l32) + 1e-6
    for k in g32:
        limit = 2 * np.abs(g16[k] - g32[k]).max() + 1e-6
        assert np.abs(t_grads[k] - g32[k]).max() <= limit, k
    assert tm.user_tower(tm._tree(), torch.arange(4)).dtype == torch.float32


def _trained_pair(feat_frames, cls, kind="conftest", **kw):
    """JAX's model with trained-looking random parameters and the port's
    holding the same, both post-fit."""
    from librecommender_tpu.utils.save_load import unflatten_tree

    (_, j_info), (t_train, t_info, _) = build_both(kind, feat_frames)
    jm, init = jax_model(cls, j_info, **kw)
    rng = np.random.default_rng(5)
    init = {k: (v + rng.normal(scale=0.1, size=np.shape(v)).astype(np.float32))
            for k, v in flat_numpy(init).items()}
    jm.params = unflatten_tree(init)
    jm.post_fit()
    tm = torch_model(cls, t_info, init, **kw)
    tm.post_fit()
    return jm, tm, t_info


@pytest.mark.parametrize("cls", ["YouTubeRetrieval", "TwoTower"])
def test_exported_embeddings_and_recommendations_match_jax(feat_frames, cls):
    jm, tm, info = _trained_pair(feat_frames, cls)
    np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tm.item_embeds_np, jm.item_embeds_np, rtol=1e-5,
                               atol=1e-6)
    width = 9 if cls == "YouTubeRetrieval" else 8   # the bias column
    assert tm.item_embeds_np.shape == (info.n_items + 1, width)
    np.testing.assert_array_equal(tm.default_recs, jm.default_recs)
    raw_users = [int(info.id2user[u]) for u in (0, 5, 17, 33)] + [-1]
    for kwargs in ({}, {"filter_consumed": False}, {"cold_start": "popular"}):
        want = jm.recommend_user(raw_users, 9, **kwargs)
        have = tm.recommend_user(raw_users, 9, **kwargs)
        for u in raw_users:
            u_vec = tm.user_embeds_np[info.user2id.get(u, info.n_users)]
            same_recs(have[u], want[u],
                      lambda i: u_vec.astype(np.float64) @ tm.item_embeds_np[
                          info.item2id[i]], (u, kwargs))


def test_two_tower_request_time_user_features(feat_frames):
    """``recommend_user(user_feats=...)``: the tower's vector with the
    overrides (a known value, an unknown one to the OOV index, a dense
    value), ranked by ``topk_from_scores``, for known users, a cold one
    under "average" and "popular", with and without the consumed filter;
    the stored tables do not change."""
    jm, tm, info = _trained_pair(feat_frames, "TwoTower")
    before = tm.user_embeds_np.copy()
    raw_users = [int(info.id2user[u]) for u in (0, 5, 17)] + [-1]
    for feats in ({"sex": "f"}, {"sex": "unknown", "age": 1.5}, {"age": -0.3}):
        for kwargs in ({}, {"filter_consumed": False}, {"cold_start": "popular"}):
            want = jm.recommend_user(raw_users, 7, user_feats=feats, **kwargs)
            have = tm.recommend_user(raw_users, 7, user_feats=feats, **kwargs)
            for u in raw_users:
                vec = tm.dyn_user_embedding(u, user_feats=feats)
                np.testing.assert_allclose(
                    vec, np.asarray(jm.dyn_user_embedding(u, user_feats=feats)),
                    rtol=1e-5, atol=1e-6)
                same_recs(have[u], want[u],
                          lambda i: vec.astype(np.float64) @ tm.item_embeds_np[
                              info.item2id[i]], (u, feats, kwargs))
    np.testing.assert_array_equal(tm.user_embeds_np, before)
    u = raw_users[1]
    np.testing.assert_array_equal(tm.recommend_user(u, 7, user_feats={})[u],
                                  tm.recommend_user(u, 7)[u])


@pytest.mark.parametrize("cls", ["YouTubeRetrieval", "TwoTower"])
@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_saved_model_loads_in_the_other_package(feat_frames, tmp_path, cls, saver):
    import json

    from librecommender_tpu import models as jmodels

    (j_train, j_info), (t_train, t_info, _) = build_both("conftest", feat_frames)
    kw = dict(n_epochs=1)
    if cls == "TwoTower":
        kw["ssl_pattern"] = "rfm"
    name = cls.lower()
    if saver == "jax":
        src, _ = jax_model(cls, j_info, **kw)
        src.fit(j_train, neg_sampling=False, verbose=0)
        src.save(tmp_path, name)
        dst = getattr(tmodels, cls).load(tmp_path, name, device="cpu")
    else:
        src = torch_model(cls, t_info, **kw)
        src.fit(t_train, neg_sampling=False, verbose=0)
        src.save(tmp_path, name)
        dst = getattr(jmodels, cls).load(tmp_path, name)
    users = np.arange(60) % t_info.n_users
    items = (np.arange(60) * 3) % t_info.n_items
    np.testing.assert_allclose(dst.predict(users, items, inner_id=True),
                               src.predict(users, items, inner_id=True), atol=1e-6)
    raw = [int(t_info.id2user[3]), -1]
    want, have = src.recommend_user(raw, 5), dst.recommend_user(raw, 5)
    for u in raw:
        np.testing.assert_array_equal(have[u], want[u])
    if saver == "torch":
        hyper = json.loads((tmp_path / f"{name}_hyper_params.json").read_text())
        assert "device" not in hyper and hyper["model_class"] == cls
        assert _serve(tmp_path, name, raw[0]) == [int(i) for i in want[raw[0]]]


def test_dropout_and_negatives_in_distribution(feat_frames):
    """The port's own draws: YouTubeRetrieval's shared negatives are uniform
    over the catalog, one set a step of ``num_sampled_per_batch`` (the batch
    size by default); same-seed fits repeat; TwoTower's tower dropout zeroes
    about ``rate`` of the hidden units in training only."""
    from librecommender_tpu_torch.ops import nn as tnn

    _, (t_train, t_info, _) = build_both("conftest", feat_frames)
    m = torch_model("YouTubeRetrieval", t_info, n_epochs=1)
    m.build_model()
    draws = torch.cat([m._shared_negatives(256) for _ in range(200)]).numpy()
    counts = np.bincount(draws, minlength=t_info.n_items)
    assert len(counts) == t_info.n_items
    expect = len(draws) / t_info.n_items
    assert np.abs(counts - expect).max() < 6 * np.sqrt(expect)
    seen = []
    m._shared_negatives = lambda n, f=m._shared_negatives: seen.append(n) or f(n)
    m.fit(t_train, neg_sampling=False, verbose=0)
    assert seen and set(seen) == {256}
    fits = []
    for _ in range(2):
        t = torch_model("TwoTower", t_info, n_epochs=1, dropout_rate=0.3)
        t.fit(t_train, neg_sampling=False, verbose=0)
        fits.append(t.params_to_arrays())
    for k in fits[0]:
        np.testing.assert_array_equal(fits[0][k], fits[1][k], err_msg=k)
    x = torch.ones(400, 50)
    out = tnn.dropout(x, 0.3, t._dropout_gen)
    assert abs(float((out == 0).float().mean()) - 0.3) < 0.02
    users = np.arange(10)
    np.testing.assert_array_equal(t.predict(users, users, inner_id=True),
                                  t.predict(users, users, inner_id=True))


def test_constructor_contract(feat_frames):
    _, (_, t_info, _) = build_both("conftest", feat_frames)
    for cls in ("YouTubeRetrieval", "TwoTower"):
        model = getattr(tmodels, cls)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                model("ranking", t_info)   # device=None means the GPU
        m = model("ranking", t_info, device="cpu")
        assert "device" not in m.all_args and m.paradigm == "listwise"
        with pytest.raises(ValueError):
            model("rating", t_info, device="cpu")
        with pytest.raises(ValueError):
            model("ranking", t_info, device="cpu", loss_type="bpr")
    tt = tmodels.TwoTower
    assert tt("ranking", t_info, device="cpu", loss_type="max_margin").paradigm == "pairwise"
    assert tt("ranking", t_info, device="cpu", loss_type="cross_entropy").paradigm == \
        "pointwise"
    for bad in (dict(ssl_pattern="cfm", loss_type="max_margin"),
                dict(ssl_pattern="other"), dict(compute_dtype="f16")):
        with pytest.raises(ValueError):
            tt("ranking", t_info, device="cpu", **bad)
    assert tt("ranking", t_info, device="cpu", alpha=0.7).ssl_alpha == 0.7


# ----------------------------------------------------------- slow checks
FIT_CASES = {
    "ytr": ("YouTubeRetrieval", {}),
    "tt-softmax": ("TwoTower", {}),
    "tt-cfm": ("TwoTower", dict(ssl_pattern="cfm")),
}


@pytest.mark.slow
@pytest.mark.parametrize("case", list(FIT_CASES))
def test_two_epoch_fit_matches_jax(feat_frames, case):
    """2 epochs at lr 0.001, ``shuffle=False``. Each step of JAX's fit takes
    one fixed key, so its draws repeat every step, and the port's seams
    return those draws."""
    import jax

    cls, kw = FIT_CASES[case]
    kw = dict(n_epochs=2, lr=0.001, **kw)
    (j_train, j_info), (t_train, t_info, _) = build_both("multi_sparse", feat_frames)
    jm, init = jax_model(cls, j_info, **kw)
    tm = torch_model(cls, t_info, init, **kw)
    key = jax.random.PRNGKey(0)
    loss_fn = jm.loss_fn
    jm.loss_fn = lambda params, batch, rng: loss_fn(params, batch, key)
    feed_jax_draws(jm, tm, key=key)
    jm.fit(j_train, neg_sampling=False, verbose=0, shuffle=False)
    tm.fit(t_train, neg_sampling=False, verbose=0, shuffle=False)
    if cls == "TwoTower":
        # the item tower's last bias shifts every logit of a row alike, so
        # the in-batch softmax's gradient there is rounding alone, which Adam
        # scales to whole steps: JAX's own fit from its start moved by 1e-7
        # lands as far off, so each array is held to twice that distance
        moved, _ = jax_model(cls, j_info, **kw)
        noise = np.random.default_rng(0)
        moved.params = jax.tree.map(
            lambda a: a + 1e-7 * noise.standard_normal(a.shape).astype(a.dtype),
            jm_init_params(init))
        moved.loss_fn = lambda params, batch, rng, f=moved.loss_fn: f(params, batch, key)
        moved.fit(j_train, neg_sampling=False, verbose=0, shuffle=False)
        within_spread(tm.params_to_arrays(), flat_numpy(jax.device_get(jm.params)),
                      flat_numpy(jax.device_get(moved.params)))
        limit = 2 * np.abs(moved.user_embeds_np - jm.user_embeds_np).max() + 1e-5
        assert np.abs(tm.user_embeds_np - jm.user_embeds_np).max() <= limit
        return
    same_params(tm.params_to_arrays(), jax.device_get(jm.params))
    np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np, rtol=1e-4,
                               atol=1e-5)


def jm_init_params(init):
    import jax.numpy as jnp

    from librecommender_tpu.utils.save_load import unflatten_tree

    return unflatten_tree({k: jnp.asarray(v) for k, v in flat_numpy(init).items()})


# model -> (JAX's AUC on the planted synthetic, PARITY.md), each as
# parity/run_ours.py runs it: embed 32, batch 2048, lr 0.001, 5 epochs,
# use_bn=False; YouTubeRetrieval on the user features only
RETRIEVAL_PARITY = {
    "YouTubeRetrieval": 0.6903,   # PARITY.md:30
    "TwoTower": 0.6901,           # PARITY.md:31
}
# PARITY.md's seed probes (BPR, LightGCN: 42, 7, 2024). One seed cannot be
# held to 0.01 here: JAX's own TwoTower lands 0.6704-0.6983 over six seeds
# and its YouTubeRetrieval 0.6816-0.6916 over these three, so the mean of
# the three is held to the band
PARITY_SEEDS = (42, 7, 2024)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(RETRIEVAL_PARITY))
def test_retrieval_model_auc_on_planted_synthetic(name):
    from librecommender_tpu_torch.data import DatasetFeat
    from parity.synthetic import chrono_split, make_ml1m_like

    from tests.test_torch_feat_models import as_columns

    train, evals = chrono_split(make_ml1m_like())
    if name == "YouTubeRetrieval":
        cols = dict(user_col=["sex", "age", "occupation"], item_col=[],
                    sparse_col=["sex", "occupation"], dense_col=["age"])
    else:
        cols = dict(user_col=["sex", "age", "occupation"], item_col=["genre"],
                    sparse_col=["sex", "occupation", "genre"], dense_col=["age"])
    train_data, info = DatasetFeat.build_trainset(as_columns(train), **cols)
    eval_data = DatasetFeat.build_evalset(as_columns(evals))
    aucs = []
    for seed in PARITY_SEEDS:
        model = getattr(tmodels, name)("ranking", info, embed_size=32, n_epochs=5,
                                       lr=0.001, batch_size=2048, use_bn=False,
                                       seed=seed, device="cpu")
        model.fit(train_data, neg_sampling=False, verbose=0, shuffle=True)
        res = evaluate(model, eval_data, neg_sampling=True, eval_batch_size=8192,
                       k=10, metrics=["roc_auc", "precision", "recall", "ndcg"],
                       seed=2222)
        print(f"port {name} on the planted synthetic, seed {seed}: {res}")
        aucs.append(res["roc_auc"])
    want = RETRIEVAL_PARITY[name]
    assert want - 0.01 <= np.mean(aucs) <= want + 0.01, aucs
