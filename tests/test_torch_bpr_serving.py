"""BPR serving in the PyTorch port against the JAX package.

A JAX BPR is fit for one epoch on the ``pure_builds`` frames and saved; the
port loads it on the CPU (the streaming top-k's plain version) and must give
the same predictions (rtol 1e-6: the same f32 products summed by numpy and by
torch), the same default recs and recommendation ids (exact), and the same
popular items (exact, ties included). Models saved by the port load in JAX.
"""
import numpy as np
import pytest
import torch

PREDICT_RTOL = 1e-6


@pytest.fixture(scope="module")
def jax_bpr(pure_frames, tmp_path_factory):
    """(fitted JAX BPR, its save directory): the trainset of ``pure_builds``."""
    from librecommender_tpu.data import DatasetPure
    from librecommender_tpu.models import BPR

    train_data, data_info = DatasetPure.build_trainset(pure_frames[0])
    model = BPR("ranking", data_info, embed_size=16, n_epochs=1, batch_size=256)
    model.fit(train_data, neg_sampling=True, verbose=0)
    path = tmp_path_factory.mktemp("jax_bpr")
    model.save(path, "bpr")
    return model, path


def _load_both(path):
    from librecommender_tpu.models import BPR as JaxBPR
    from librecommender_tpu_torch.models import BPR

    return JaxBPR.load(path, "bpr"), BPR.load(path, "bpr", device="cpu")


def _users(model, n=6):
    return [model.data_info.id2user[i] for i in range(n)]


def test_predict_matches_jax(jax_bpr):
    jm, path = jax_bpr
    _, pm = _load_both(path)
    users = _users(jm) + [-1]                   # a cold user
    items = [jm.data_info.id2item[i] for i in range(6)] + [-7]  # a cold item
    np.testing.assert_allclose(
        pm.predict(users, items), jm.predict(users, items), rtol=PREDICT_RTOL
    )
    np.testing.assert_allclose(
        pm.predict(users[0], items[0]), jm.predict(users[0], items[0]),
        rtol=PREDICT_RTOL,
    )


def test_default_recs_match_jax(jax_bpr):
    jm, path = jax_bpr
    _, pm = _load_both(path)
    np.testing.assert_array_equal(pm.default_recs, jm.default_recs)
    # recomputed from the loaded parameters, not only read back
    pm.build_default_recs()
    np.testing.assert_array_equal(pm.default_recs, jm.default_recs)


@pytest.mark.parametrize("case", [
    dict(user="known", n_rec=10),
    dict(user="known", n_rec=10, filter_consumed=False),
    dict(user="known", n_rec=37),
    dict(user="cold", n_rec=10, cold_start="average"),
    dict(user="cold", n_rec=10, cold_start="popular"),
    dict(user="batch", n_rec=7),
    dict(user="batch", n_rec=7, filter_consumed=False),
    dict(user="mixed", n_rec=5, cold_start="popular"),
    dict(user="known", n_rec=8, random_rec=True),
])
def test_recommend_user_matches_jax(jax_bpr, case):
    jm, path = jax_bpr
    # fresh loads: random_rec draws from each DataInfo's seeded generator
    jl, pm = _load_both(path)
    case = dict(case)
    who = case.pop("user")
    users = {
        "known": _users(jm, 1),
        "cold": [987654],
        "batch": _users(jm, 6),
        "mixed": _users(jm, 3) + [987654],
    }[who]
    arg = users[0] if len(users) == 1 else users
    got = pm.recommend_user(arg, **case)
    want = jl.recommend_user(arg, **case)
    assert list(got) == list(want)
    for u in want:
        np.testing.assert_array_equal(np.asarray(got[u]), np.asarray(want[u]))
    if who == "known" and case.get("filter_consumed", True):
        uid = jm.data_info.user2id[users[0]]
        recs = {jm.data_info.item2id[i] for i in got[users[0]]}
        assert not recs & set(jm.data_info.user_consumed[uid])


def test_popular_items_match_jax_with_ties(tmp_path):
    """Many items share a distinct-user count; the port's numpy order must
    equal pandas' groupby + sort_values order, fresh and after save/load."""
    import pandas as pd

    from librecommender_tpu.data import DatasetPure
    from librecommender_tpu.data.data_info import DataInfo as JaxDataInfo
    from librecommender_tpu_torch.data import DataInfo

    rng = np.random.default_rng(5)
    n = 3000
    frame = pd.DataFrame({
        "user": rng.integers(0, 300, n) + 100,
        "item": rng.integers(0, 400, n) + 9000,
        "label": np.ones(n),
    })
    frame = pd.concat([frame, frame.iloc[:200]])  # repeated pairs count once
    _, jinfo = DatasetPure.build_trainset(frame)
    info = DataInfo(
        interaction_data=frame[["user", "item", "label"]].to_numpy(),
        user_consumed=jinfo.user_consumed,
        user_unique_vals=jinfo.user_unique_vals,
        item_unique_vals=jinfo.item_unique_vals,
    )
    counts = frame.drop_duplicates(["user", "item"]).groupby("item").size()
    assert counts.value_counts().max() > 20  # the order hinges on ties
    assert info.popular_items == jinfo.popular_items
    jinfo.save(tmp_path, "m")
    assert DataInfo.load(tmp_path, "m").popular_items == jinfo.popular_items
    info.save(tmp_path / "port", "m")
    assert JaxDataInfo.load(tmp_path / "port", "m").popular_items == jinfo.popular_items


@pytest.mark.parametrize("norm_embed", [False, True])
def test_bpr_params_from_jax_matches_set_embeddings(jax_bpr, norm_embed):
    from librecommender_tpu.models import BPR as JaxBPR
    from librecommender_tpu_torch.convert import bpr_params_from_jax
    from librecommender_tpu_torch.models import BPR

    fitted, _ = jax_bpr
    params = {k: np.asarray(v) for k, v in fitted.params.items()}
    jm = JaxBPR("ranking", fitted.data_info, embed_size=16, norm_embed=norm_embed)
    jm.params = fitted.params
    jm.set_embeddings()
    tensors = bpr_params_from_jax(params, "cpu")
    for k in params:
        assert tensors[k].dtype == torch.float32
        np.testing.assert_array_equal(tensors[k].numpy(), params[k])
    pm = BPR("ranking", fitted.data_info, embed_size=16, norm_embed=norm_embed,
             device="cpu")
    pm.params_from_arrays(params)
    pm.set_embeddings()
    np.testing.assert_array_equal(pm.user_embeds_np, jm.user_embeds_np)
    np.testing.assert_array_equal(pm.item_embeds_np, jm.item_embeds_np)
    np.testing.assert_array_equal(pm.user_embeds.numpy(), jm.user_embeds_np)
    with pytest.raises(ValueError):
        bpr_params_from_jax({"user_embed": params["user_embed"]}, "cpu")


def test_port_saved_model_loads_in_jax(jax_bpr, tmp_path):
    from librecommender_tpu.models import BPR as JaxBPR

    jm, path = jax_bpr
    _, pm = _load_both(path)
    pm.save(tmp_path, "again")
    back = JaxBPR.load(tmp_path, "again")
    users = _users(jm, 6)
    want, got = back.recommend_user(users, 9), pm.recommend_user(users, 9)
    for u in users:
        np.testing.assert_array_equal(got[u], want[u])
    items = [jm.data_info.id2item[i] for i in range(6)]
    np.testing.assert_allclose(back.predict(users, items), jm.predict(users, items),
                               rtol=PREDICT_RTOL)
    np.testing.assert_array_equal(back.default_recs, jm.default_recs)


def test_inference_only_save_load(jax_bpr, tmp_path):
    from librecommender_tpu.models import BPR as JaxBPR
    from librecommender_tpu_torch.models import BPR

    jm, path = jax_bpr
    _, pm = _load_both(path)
    pm.save(tmp_path, "emb", inference_only=True)
    assert (tmp_path / "emb_embeddings.npz").exists()
    users = _users(jm, 4) + [424242]
    for loaded in (BPR.load(tmp_path, "emb", device="cpu"),
                   JaxBPR.load(tmp_path, "emb")):
        want, got = pm.recommend_user(users, 6), loaded.recommend_user(users, 6)
        for u in users:
            np.testing.assert_array_equal(np.asarray(want[u]), np.asarray(got[u]))
    np.testing.assert_array_equal(
        BPR.load(tmp_path, "emb", device="cpu").get_item_embedding(),
        jm.get_item_embedding(),
    )


def test_build_model_layout(jax_bpr):
    from librecommender_tpu_torch.models import BPR

    jm, _ = jax_bpr
    pm = BPR("ranking", jm.data_info, embed_size=16, device="cpu", seed=3)
    pm.build_model()
    ue, ie = pm.net["user_embed"], pm.net["item_embed"]
    # the JAX package's layout: rows aligned, item bias in column D
    assert ue.shape == jm.params["user_embed"].shape
    assert ie.shape == jm.params["item_embed"].shape
    assert (ie[:, 16] == 0).all() and ue.abs().max() <= 0.1
    pm.post_fit()
    assert pm.default_recs.shape == (min(100, pm.n_items),)
    assert "device" not in pm.all_args


def test_truncated_normal_matches_jax_distribution():
    """Same distribution (normal(0, 0.05) cut at +/- 2 sd); the bits differ."""
    import jax
    from scipy import stats

    from librecommender_tpu.ops.initializers import truncated_normal as jax_tn
    from librecommender_tpu_torch.ops.initializers import truncated_normal

    ours = truncated_normal(torch.Generator().manual_seed(0), (200_000,)).numpy()
    ref = np.asarray(jax_tn(jax.random.PRNGKey(0), (200_000,)))
    assert ours.dtype == np.float32
    assert np.abs(ours).max() <= 0.1 and np.abs(ref).max() <= 0.1
    assert stats.ks_2samp(ours, ref).statistic < 0.01
    assert abs(ours.std() - ref.std()) < 5e-4
