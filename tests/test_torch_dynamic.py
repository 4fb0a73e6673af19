"""Request-time features and sequences, feature updates and batched
prediction with features: the PyTorch port against itself (the dynamic path
with the stored state equals the static path) and against the JAX package,
on the CPU.

Both packages build the ``tests/conftest.py`` feature frame (and the
multi-sparse frame of ``tests/test_torch_feat_data.py``) and the port starts
from JAX's initial parameters. Recommendation ids are exact; predictions
rtol 1e-5; the unique feature tables after an update exact. Port-only
checks mirror ``tests/models/test_dynamic_equivalence.py``.
"""
import numpy as np
import pytest
import torch

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.data import DatasetFeat
from librecommender_tpu_torch.prediction import predict_data_with_feats

FEAT_COLS = dict(user_col=["sex", "age"], item_col=["genre"],
                 sparse_col=["sex", "genre"], dense_col=["age"])
SMALL = dict(embed_size=8, batch_size=256, seed=3)

# name -> (model class, kwargs beside SMALL)
MODELS = {
    "fm": ("FM", {}),
    "deepfm": ("DeepFM", dict(hidden_units=(16, 8))),
    "din": ("DIN", dict(hidden_units=(16, 8), recent_num=5)),
    "din_concat": ("DIN", dict(hidden_units=(16, 8), recent_num=5,
                               feat_agg_mode="concat")),
    "youtube": ("YouTubeRanking", dict(hidden_units=(16, 8), recent_num=5)),
    "transformer": ("Transformer", dict(hidden_units=(16, 8), recent_num=5,
                                        compute_dtype="f32")),
    "transformer_deep": ("Transformer", dict(
        hidden_units=(16, 8), recent_num=5, compute_dtype="f32",
        num_tfm_layers=2, feat_agg_mode=None, num_heads=1)),
    "sim": ("SIM", dict(hidden_units=(16,), recent_num=5, long_max_len=20,
                        search_topk=5)),
}


def as_columns(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


def _build_both(kind, feat_frames):
    from librecommender_tpu.data import DatasetFeat as JDatasetFeat

    if kind == "conftest":
        train, _, _ = feat_frames
        cols = FEAT_COLS
    else:
        from tests.test_torch_feat_data import MULTI_COLS, _multi_sparse_frames

        train, _ = _multi_sparse_frames()
        cols = MULTI_COLS
    _, j_info = JDatasetFeat.build_trainset(train, **cols)
    _, t_info = DatasetFeat.build_trainset(as_columns(train), **cols)
    return j_info, t_info, train


@pytest.fixture()
def infos(feat_frames):
    return _build_both("conftest", feat_frames)


def pair(name, j_info, t_info):
    """(JAX model, port model) of ``name`` from JAX's initial parameters."""
    import jax

    from librecommender_tpu import models as jmodels

    cls, extra = MODELS[name]
    kw = {**SMALL, **extra}
    jm = getattr(jmodels, cls)("ranking", j_info, **kw)
    jm.build_model()
    tm = getattr(tmodels, cls)("ranking", t_info, device="cpu", **kw)
    tm.params_from_arrays(jax.device_get(jm.params))
    return jm, tm


def stored_request_seq(model, uid):
    """The user's consumed items as an inner-id request list whose
    conversion gives the stored recent history."""
    return [int(i) for i in model.user_consumed[uid]]


def same_recs(a, b, users):
    for u in users:
        np.testing.assert_array_equal(np.asarray(a[u]), np.asarray(b[u]), err_msg=u)


# (model, the override): the stored state passed as a request must give the
# static path's ids
EQUIVALENCE = [("fm", "feats"), ("deepfm", "feats"), ("din", "feats"),
               ("din", "seq"), ("youtube", "seq"), ("transformer", "seq"),
               ("transformer_deep", "seq"), ("sim", "seq")]


@pytest.mark.parametrize("name,kind", EQUIVALENCE,
                         ids=[f"{n}-{k}" for n, k in EQUIVALENCE])
def test_dynamic_equals_static_and_jax(infos, name, kind):
    j_info, t_info, _ = infos
    jm, tm = pair(name, j_info, t_info)
    uids = [0, 1, 2, 5]
    if kind == "feats":   # the stored rows pass through the override assembly
        kw = dict(user_feats={})
    else:
        kw = dict(seq=[stored_request_seq(tm, u) for u in uids])
    static = tm.recommend_user(uids, 6, inner_id=True)
    dynamic = tm.recommend_user(uids, 6, inner_id=True, **kw)
    same_recs(dynamic, static, uids)
    same_recs(dynamic, jm.recommend_user(uids, 6, inner_id=True, **kw), uids)


@pytest.mark.parametrize("name", ["din", "sim"])
def test_mixed_users_partial_overrides(infos, name):
    """Per-user seq lists where one user's differs from the stored history:
    the others keep the static result, that user's equals its single-user
    call, chunked over users or not, and every list equals JAX's."""
    j_info, t_info, _ = infos
    jm, tm = pair(name, j_info, t_info)
    uids = [0, 1, 2]
    other = list(range(10, 15))
    seqs = [stored_request_seq(tm, 0), other, stored_request_seq(tm, 2)]
    static = tm.recommend_user(uids, 6, inner_id=True)
    dynamic = tm.recommend_user(uids, 6, inner_id=True, seq=seqs)
    same_recs(dynamic, static, [0, 2])
    assert not np.array_equal(dynamic[1], static[1])
    solo = tm.recommend_user(1, 6, inner_id=True, seq=other)
    np.testing.assert_array_equal(solo[1], dynamic[1])
    tm._users_per_call_cap = 2   # two chunks of users
    same_recs(tm.recommend_user(uids, 6, inner_id=True, seq=seqs), dynamic, uids)
    same_recs(dynamic, jm.recommend_user(uids, 6, inner_id=True, seq=seqs), uids)


@pytest.mark.parametrize("name", ["fm", "din", "sim"])
def test_request_features_match_jax(infos, name):
    """Real request features, one dict for every user and one per user (an
    unknown value, a raw user unknown to the model), and a shared request
    seq with unknown items: the ids equal JAX's."""
    j_info, t_info, _ = infos
    jm, tm = pair(name, j_info, t_info)
    raw = [int(t_info.id2user[u]) for u in (0, 3, 8)] + [-7]
    cases = [
        dict(user_feats={"sex": "f", "age": 0.7}),
        dict(user_feats=[{"sex": "m"}, {"age": -1.5}, {"sex": "x"}, {}]),
        dict(user_feats={"sex": "f"},
             seq=[int(t_info.id2item[i]) for i in (4, 9, 2)] + [-3]),
        dict(user_feats={"sex": "m"}, filter_consumed=False),
    ]
    static = tm.recommend_user(raw, 6)
    for kw in cases:
        have = tm.recommend_user(raw, 6, **kw)
        same_recs(have, jm.recommend_user(raw, 6, **kw), raw)
    assert any(not np.array_equal(have[u], static[u]) for u in raw)


def test_dynamic_overrides_are_checked(infos):
    j_info, t_info, _ = infos
    _, tm = pair("din", j_info, t_info)
    with pytest.raises(ValueError, match="one entry per user"):
        tm.recommend_user([0, 1], 5, inner_id=True, user_feats=[{}])
    with pytest.raises(ValueError, match="one list per user"):
        tm.recommend_user([0, 1, 2], 5, inner_id=True, seq=[[1, 2], [3]])
    with pytest.raises(ValueError, match="one pair"):
        tm.predict([0, 1], [0, 1], inner_id=True, feats={"sex": "f"})
    # a flat list is one sequence shared by every user
    shared = tm.recommend_user([0, 1], 5, inner_id=True, seq=[3, 4])
    np.testing.assert_array_equal(
        shared[1], tm.recommend_user(1, 5, inner_id=True, seq=[3, 4])[1])


def test_dynamic_halves_the_user_chunk_when_memory_runs_out(infos, monkeypatch):
    j_info, t_info, _ = infos
    _, tm = pair("din", j_info, t_info)
    users = list(range(9))
    kw = dict(user_feats={"sex": "f"})
    want = tm.recommend_user(users, 5, inner_id=True, **kw)
    score, calls = tm._score_users, []

    def short_of_memory(uids, overrides=None):
        calls.append(len(uids))
        assert len(overrides["user_sparse_row"]) == len(uids)
        if len(uids) > 2:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return score(uids, overrides)

    monkeypatch.setattr(tm, "_score_users", short_of_memory)
    same_recs(tm.recommend_user(users, 5, inner_id=True, **kw), want, users)
    assert calls[:3] == [9, 4, 2] and tm._users_per_call_cap == 2


@pytest.mark.parametrize("name", ["fm", "deepfm", "din", "sim"])
def test_predict_with_feats_matches_jax(infos, name):
    """predict(feats=...) for one pair: a known user with new features, an
    unknown value (the column's OOV), a cold user; rtol 1e-5 against JAX,
    and no features equal the stored ones."""
    j_info, t_info, _ = infos
    jm, tm = pair(name, j_info, t_info)
    user, item = int(t_info.id2user[4]), int(t_info.id2item[7])
    for u, feats in ((user, {"sex": "f", "age": 0.25}), (user, {"sex": "?"}),
                     (-1, {"age": 2.0}), (user, {})):
        have = tm.predict(u, item, feats=feats)
        assert isinstance(have, float)
        np.testing.assert_allclose(have, jm.predict(u, item, feats=feats), rtol=1e-5)
    np.testing.assert_allclose(tm.predict(user, item, feats={}),
                               tm.predict(user, item), rtol=1e-6)


@pytest.mark.parametrize("kind", ["conftest", "multi_sparse"])
@pytest.mark.parametrize("name", ["fm", "din"])
def test_predict_data_with_feats_matches_jax(feat_frames, kind, name):
    """Rows scored with their own features (unknown values and a cold user
    among them): the port's column dict against JAX's DataFrame at rtol
    1e-5; a missing feature column raises in both packages."""
    import pandas as pd

    from librecommender_tpu.prediction import predict_data_with_feats as j_predict

    j_info, t_info, train = _build_both(kind, feat_frames)
    jm, tm = pair(name, j_info, t_info)
    rows = as_columns(train.iloc[:50])
    rows["user"] = rows["user"].copy()
    rows["user"][0] = -12345
    rows["sex"] = rows["sex"].astype(object)
    rows["sex"][:10] = np.array(["f", "m", "?"] * 3 + ["f"], dtype=object)
    have = predict_data_with_feats(tm, rows, batch_size=16)
    want = j_predict(jm, pd.DataFrame(rows), batch_size=16)
    np.testing.assert_allclose(have, want, rtol=1e-5)
    missing = {k: v for k, v in rows.items() if k != "age"}
    with pytest.raises(ValueError, match="age"):
        predict_data_with_feats(tm, missing)
    with pytest.raises(ValueError):
        predict_data_with_feats(tm, rows, cold_start="bogus")


def _tables(info):
    return {k: getattr(info, k) for k in ("user_sparse_unique", "user_dense_unique",
                                          "item_sparse_unique", "item_dense_unique")}


@pytest.mark.parametrize("name", ["fm", "din_concat"])
def test_assign_features_match_jax(infos, name):
    """The same user and item updates in both packages (a repeated id, whose
    last row wins; an unknown id; a value outside the vocabulary; a partial
    column set): the unique tables are equal, ``feature_version`` moves, and
    recommendations and predictions afterwards equal JAX's, so the port's
    device tables were rebuilt."""
    import pandas as pd

    j_info, t_info, _ = infos
    jm, tm = pair(name, j_info, t_info)
    raw_users = [int(t_info.id2user[u]) for u in (0, 1, 2, 6)]
    raw_items = [int(t_info.id2item[i]) for i in (0, 3, 5)]
    before = tm.recommend_user(raw_users, 6)
    user_rows = {"user": np.array(raw_users + [raw_users[0], 10**8]),
                 "sex": np.array(["f", "m", "?", "f", "m", "f"], dtype=object),
                 "age": np.array([0.9, -0.4, 0.1, 1.3, -2.0, 0.5])}
    item_rows = {"item": np.array(raw_items + [raw_items[1]]),
                 "genre": np.array([t_info.sparse_unique_vals["genre"][j]
                                    for j in (2, 0, 1, 3)], dtype=object)}
    version = t_info.feature_version
    for info, rows in ((t_info, user_rows), (j_info, pd.DataFrame(user_rows))):
        info.assign_user_features(rows)
    for info, rows in ((t_info, item_rows), (j_info, pd.DataFrame(item_rows))):
        info.assign_item_features(rows)
    assert t_info.feature_version == version + 2
    for k, v in _tables(t_info).items():
        np.testing.assert_array_equal(v, getattr(j_info, k), err_msg=k)
    assert tm.feats.version == version   # rebuilt at the next inference call
    after = tm.recommend_user(raw_users, 6)
    assert tm.feats.version == version + 2
    same_recs(after, jm.recommend_user(raw_users, 6), raw_users)
    assert any(not np.array_equal(after[u], before[u]) for u in raw_users)
    users, items = np.arange(30) % t_info.n_users, np.arange(30) % t_info.n_items
    np.testing.assert_allclose(tm.predict(users, items, inner_id=True),
                               jm.predict(users, items, inner_id=True), rtol=1e-5)
    with pytest.raises(ValueError, match="user"):
        t_info.assign_user_features({"sex": np.array(["f"])})


def test_assign_features_on_multi_sparse_columns(feat_frames):
    """An item update of the multi-sparse genre columns and a user update of
    a dense column only: the tables equal JAX's."""
    import pandas as pd

    j_info, t_info, train = _build_both("multi_sparse", feat_frames)
    items = train["item"].unique()[:4]
    item_rows = {"item": items, "genre1": np.array(["e", "a", "zz", "b"], object),
                 "genre3": np.array(["c", "missing", "d", "a"], object),
                 "year": np.array([1995, 1990, 2050, 1999])}
    user_rows = {"user": train["user"].unique()[:3], "age": np.array([1.0, 2.0, 3.0])}
    for info, wrap in ((t_info, dict), (j_info, pd.DataFrame)):
        info.assign_item_features(wrap(item_rows))
        info.assign_user_features(wrap(user_rows))
    for k, v in _tables(t_info).items():
        np.testing.assert_array_equal(v, getattr(j_info, k), err_msg=k)
