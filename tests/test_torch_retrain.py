"""Retraining in the PyTorch port against the JAX package on the CPU:
``merge_trainset`` -> ``rebuild_model`` -> ``fit``, optimizer state as optax
leaves, and checkpoints.

Mirrors ``tests/test_retrain.py`` (all but the mesh case, which waits for the
multi-device slice) and holds the port to JAX where both compute the same
thing: ``merge_trainset``'s DataInfo, indices, consumed lists and feature
tables exactly; parameters and optimizer leaves grafted from one save
exactly (the port starts from the JAX model's fresh parameters, so that the
rows grafting leaves alone agree too); optimizer leaves after one epoch on
the same batches within 1e-4 of each leaf's largest magnitude;
checkpoints and opt-state files written by either package and read by the
other bit for bit; UserCF's and ItemCF's incremental update against JAX's
(ids by the near-tie rule of ``test_torch_cf_models``, values rtol 1e-5).
"""
import numpy as np
import pytest

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.convert import opt_leaves_from_jax
from librecommender_tpu_torch.data import DatasetFeat, DatasetPure
from librecommender_tpu_torch.utils.save_load import flatten_tree

from tests.conftest import make_feat_interactions, make_interactions

FEAT = dict(user_col=["sex", "age"], item_col=["genre"],
            sparse_col=["sex", "genre"], dense_col=["age"])
EMBED = dict(embed_size=8, n_epochs=1, batch_size=256)


def cols(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


def _new_data(frame, n_new_users=5, n_new_items=8, seed=7):
    """Second-period data: some old users/items and new ids (the JAX
    package's ``tests/test_retrain.py`` helper)."""
    rng = np.random.default_rng(seed)
    extra = frame.sample(frac=0.3, random_state=seed).copy()
    new_users = rng.integers(5000, 5000 + n_new_users, len(extra) // 2)
    extra.iloc[: len(new_users), extra.columns.get_loc("user")] = new_users
    new_items = rng.integers(9000, 9000 + n_new_items, len(extra) // 3)
    extra.iloc[: len(new_items), extra.columns.get_loc("item")] = new_items
    return extra.drop_duplicates(subset=["user", "item"]).reset_index(drop=True)


def feat_frames():
    frame = make_feat_interactions()
    new_frame = _new_data(frame)
    new_frame["genre"] = new_frame["genre"].astype(object)
    new_frame.iloc[:10, new_frame.columns.get_loc("genre")] = "e"
    return frame, new_frame


def jax_leaves(state):
    import jax

    return opt_leaves_from_jax(jax.tree_util.tree_leaves(jax.device_get(state)))


def same_leaves(got, want, rtol=0.0):
    """Leaf by leaf: shape and dtype, then equal, or with ``rtol`` within
    ``rtol`` of the leaf's largest magnitude."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.shape(g) == np.shape(w) and np.asarray(g).dtype == np.asarray(w).dtype, i
        if rtol == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
        else:
            scale = float(np.abs(w).max(initial=0.0))
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale,
                                       err_msg=f"leaf {i}")


def same_tree(got, want, exact=True):
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k in want:
        if exact:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


# ------------------------------------------------------------ merge_trainset
def _same_info(got, want):
    for attr in ("user_unique_vals", "item_unique_vals"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert got.user_consumed == want.user_consumed
    assert got.item_consumed == want.item_consumed
    np.testing.assert_array_equal(got.interaction_data.to_numpy().astype(str),
                                  want.interaction_data.to_numpy().astype(str))
    assert got.popular_items == want.popular_items
    assert ({k: np.asarray(v).tolist() for k, v in got.old_info.__dict__.items()}
            == {k: np.asarray(v).tolist() for k, v in want.old_info.__dict__.items()})


def _same_set(got, want):
    np.testing.assert_array_equal(got.user_indices, want.user_indices)
    np.testing.assert_array_equal(got.item_indices, want.item_indices)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.sparse_interaction != want.sparse_interaction).nnz == 0


@pytest.mark.parametrize("merge_behavior", [True, False])
def test_merge_trainset_pure_matches_jax(merge_behavior):
    from librecommender_tpu.data import DatasetPure as JDatasetPure

    frame = make_interactions()
    new_frame = _new_data(frame)
    _, j_info = JDatasetPure.build_trainset(frame)
    j_train, j_new = JDatasetPure.merge_trainset(new_frame, j_info, merge_behavior)
    j_eval = JDatasetPure.merge_evalset(new_frame, j_new)
    _, t_info = DatasetPure.build_trainset(cols(frame))
    t_train, t_new = DatasetPure.merge_trainset(cols(new_frame), t_info, merge_behavior)
    t_eval = DatasetPure.merge_evalset(cols(new_frame), t_new)
    _same_info(t_new, j_new)
    _same_set(t_train, j_train)
    np.testing.assert_array_equal(t_eval.item_indices, j_eval.item_indices)
    assert t_new.n_users > t_info.n_users and t_new.n_items > t_info.n_items


def test_merge_trainset_feat_matches_jax():
    """A new sparse value grows the vocabulary: offsets, OOV positions, the
    unique feature tables and the train matrices are JAX's."""
    from librecommender_tpu.data import DatasetFeat as JDatasetFeat

    frame, new_frame = feat_frames()
    _, j_info = JDatasetFeat.build_trainset(frame, **FEAT)
    j_train, j_new = JDatasetFeat.merge_trainset(new_frame, j_info)
    j_test = JDatasetFeat.merge_testset(new_frame, j_new)
    _, t_info = DatasetFeat.build_trainset(cols(frame), **FEAT)
    t_train, t_new = DatasetFeat.merge_trainset(cols(new_frame), t_info)
    t_test = DatasetFeat.merge_testset(cols(new_frame), t_new)
    _same_info(t_new, j_new)
    _same_set(t_train, j_train)
    np.testing.assert_array_equal(t_train.sparse_indices, j_train.sparse_indices)
    np.testing.assert_array_equal(t_train.dense_values, j_train.dense_values)
    for attr in ("sparse_offset", "sparse_oov", "user_sparse_unique",
                 "item_sparse_unique", "user_dense_unique", "item_dense_unique"):
        np.testing.assert_array_equal(getattr(t_new, attr), getattr(j_new, attr),
                                      err_msg=attr)
    for col, vals in j_new.sparse_unique_vals.items():
        np.testing.assert_array_equal(t_new.sparse_unique_vals[col], vals)
    assert t_new.sparse_offset[-1] >= t_info.sparse_offset[-1]
    np.testing.assert_array_equal(t_test.user_indices, j_test.user_indices)


# ------------------------------------------------- the JAX package's flows
@pytest.mark.parametrize("cls", ["SVD", "BPR", "LightGCN"])
def test_pure_retrain_flow(cls, tmp_path):
    frame = make_interactions()
    new_frame = _new_data(frame)
    train, info = DatasetPure.build_trainset(cols(frame))
    model = getattr(tmodels, cls)("ranking", info, device="cpu", **EMBED)
    model.fit(train, neg_sampling=True, verbose=0)
    model.save(tmp_path, cls)
    new_train, new_info = DatasetPure.merge_trainset(cols(new_frame), info)
    assert new_info.old_info is not None
    model2 = getattr(tmodels, cls)("ranking", new_info, device="cpu", **EMBED)
    model2.rebuild_model(tmp_path, cls)
    old = model.params_to_arrays()["user_embed"][: info.n_users]
    np.testing.assert_array_equal(model2.params_to_arrays()["user_embed"][: info.n_users], old)
    model2.fit(new_train, neg_sampling=True, verbose=0)
    old_user, new_user = frame.user.iloc[0], new_frame.user.iloc[0]
    recs = model2.recommend_user(user=[old_user, new_user], n_rec=5)
    assert len(recs[old_user]) == 5 and len(recs[new_user]) == 5


def test_feat_retrain_flow(tmp_path):
    frame, new_frame = feat_frames()
    train, info = DatasetFeat.build_trainset(cols(frame), **FEAT)
    model = tmodels.FM("ranking", info, device="cpu", **EMBED)
    model.fit(train, neg_sampling=True, verbose=0)
    model.save(tmp_path, "FM")
    new_train, new_info = DatasetFeat.merge_trainset(cols(new_frame), info)
    model2 = tmodels.FM("ranking", new_info, device="cpu", **EMBED)
    model2.rebuild_model(tmp_path, "FM")
    old_sp = model.params_to_arrays()["sparse_embed"]
    new_sp = model2.params_to_arrays()["sparse_embed"]
    old_off = 0
    for col_idx, length in enumerate(new_info.old_info.sparse_len):
        if length == -1:
            continue
        n_off = int(new_info.sparse_offset[col_idx])
        np.testing.assert_array_equal(old_sp[old_off:old_off + length],
                                      new_sp[n_off:n_off + length])
        old_off += length + 1
    model2.fit(new_train, neg_sampling=True, verbose=0)
    user = frame.user.iloc[0]
    assert len(model2.recommend_user(user=user, n_rec=5)[user]) == 5


def test_i2i_retrain_flow(tmp_path):
    frame = make_interactions()
    new_frame = _new_data(frame)
    kw = dict(embed_size=8, n_epochs=1, batch_size=128, paradigm="i2i",
              num_walks=2, sample_walk_len=2)
    train, info = DatasetPure.build_trainset(cols(frame))
    model = tmodels.GraphSage("ranking", info, device="cpu", **kw)
    model.fit(train, neg_sampling=True, verbose=0)
    model.save(tmp_path, "GraphSage")
    new_train, new_info = DatasetPure.merge_trainset(cols(new_frame), info)
    model2 = tmodels.GraphSage("ranking", new_info, device="cpu", **kw)
    model2.rebuild_model(tmp_path, "GraphSage")
    np.testing.assert_array_equal(
        model2.params_to_arrays()["item_embed"][: info.n_items],
        model.params_to_arrays()["item_embed"][: info.n_items])
    model2.fit(new_train, neg_sampling=True, verbose=0)
    assert model2.item_nbr.shape[0] == new_info.n_items
    old_user, new_user = frame.user.iloc[0], new_frame.user.iloc[0]
    recs = model2.recommend_user(user=[old_user, new_user], n_rec=5)
    assert len(recs[old_user]) == 5 and len(recs[new_user]) == 5


@pytest.mark.parametrize("name", ["UserCF", "ItemCF"])
def test_cf_incremental_update_matches_jax(name, tmp_path):
    """JAX's save, rebuilt in both packages and fitted on the merged data:
    the port's incremental lists are JAX's; recommendations work for old
    and new users."""
    from librecommender_tpu import models as jmodels
    from librecommender_tpu.data import DatasetPure as JDatasetPure

    from tests.test_torch_cf_models import assert_ids_near_tie, exact_sims

    frame = make_interactions()
    new_frame = _new_data(frame)
    j_train, j_info = JDatasetPure.build_trainset(frame)
    jm = getattr(jmodels, name)("ranking", j_info, k_sim=10)
    jm.fit(j_train, neg_sampling=True, verbose=0)
    jm.save(tmp_path, name)
    j_new_train, j_new = JDatasetPure.merge_trainset(new_frame, j_info)
    jm2 = getattr(jmodels, name)("ranking", j_new, k_sim=10).rebuild_model(tmp_path, name)
    jm2.fit(j_new_train, neg_sampling=True, verbose=0)
    _, t_info = DatasetPure.build_trainset(cols(frame))
    t_new_train, t_new = DatasetPure.merge_trainset(cols(new_frame), t_info)
    tm2 = getattr(tmodels, name)("ranking", t_new, k_sim=10, device="cpu")
    tm2.rebuild_model(tmp_path, name)
    tm2.fit(t_new_train, neg_sampling=True, verbose=0)
    assert (tm2.interaction != jm2.interaction).nnz == 0
    entity = tm2.interaction if name == "UserCF" else tm2.interaction.T.tocsr()
    assert_ids_near_tie(tm2.sim_ids, jm2.sim_ids, exact_sims(entity, "cosine"), name)
    np.testing.assert_allclose(tm2.sim_vals, jm2.sim_vals, rtol=1e-5, atol=1e-6)
    user = new_frame.user.iloc[0]
    assert len(tm2.recommend_user(user=user, n_rec=5)[user]) == 5


def test_optimizer_state_grafted(tmp_path):
    frame = make_interactions()
    train, info = DatasetPure.build_trainset(cols(frame))
    model = tmodels.SVD("ranking", info, device="cpu", **{**EMBED, "n_epochs": 2})
    model.fit(train, neg_sampling=True, verbose=0)
    model.save(tmp_path, "SVD")
    leaves = model.trainer.opt_state_leaves()
    mu = leaves[1 + sorted(model.net.keys()).index("user_embed")]
    assert np.any(mu != 0)
    new_train, new_info = DatasetPure.merge_trainset(cols(_new_data(frame)), info)
    model2 = tmodels.SVD("ranking", new_info, device="cpu", **EMBED)
    model2.rebuild_model(tmp_path, "SVD")
    assert model2._initial_opt_state[0] == "graft"
    model2.fit(new_train, neg_sampling=True, verbose=0)


def test_checkpoint_resume(tmp_path):
    """A checkpoint restores the parameters and the optimizer leaves bit
    for bit, and training continues from them."""
    frame = make_interactions()
    train, info = DatasetPure.build_trainset(cols(frame))
    model = tmodels.SVD("ranking", info, device="cpu", **{**EMBED, "n_epochs": 3})
    model.fit(train, neg_sampling=True, verbose=0, checkpoint_dir=tmp_path)
    model2 = tmodels.SVD("ranking", info, device="cpu", **{**EMBED, "n_epochs": 0})
    assert model2.load_checkpoint(tmp_path) == 3
    same_tree(model2.params_to_arrays(), model.params_to_arrays())
    model2.fit(train, neg_sampling=True, verbose=0)
    same_leaves(model2.trainer.opt_state_leaves(), model.trainer.opt_state_leaves())
    model2.n_epochs = 1
    model2.fit(train, neg_sampling=True, verbose=0)
    assert model2.user_embeds_np is not None


def test_legacy_pickle_checkpoint_raises(tmp_path):
    frame = make_interactions()
    _, info = DatasetPure.build_trainset(cols(frame))
    (tmp_path / "checkpoint.pkl").write_bytes(b"not read")
    with pytest.raises(ValueError, match="legacy pickle"):
        tmodels.SVD("ranking", info, device="cpu", **EMBED).load_checkpoint(tmp_path)


@pytest.mark.parametrize("cls_name", ["DIN", "TwoTower", "RNN4Rec"])
def test_seq_and_tower_retrain(cls_name, tmp_path):
    frame, new_frame = feat_frames()
    new_frame.loc[new_frame.index[:5], "genre"] = "zz"
    train, info = DatasetFeat.build_trainset(cols(frame), **FEAT)
    extra = {"DIN": dict(recent_num=5, hidden_units=(16,)),
             "TwoTower": dict(loss_type="softmax", hidden_units=(16,)),
             "RNN4Rec": {}}[cls_name]
    neg = cls_name != "TwoTower"
    cls = getattr(tmodels, cls_name)
    model = cls("ranking", info, device="cpu", **EMBED, **extra)
    model.fit(train, neg_sampling=neg, verbose=0)
    model.save(tmp_path, cls_name)
    new_train, new_info = DatasetFeat.merge_trainset(cols(new_frame), info)
    model2 = cls("ranking", new_info, device="cpu", **EMBED, **extra)
    model2.rebuild_model(tmp_path, cls_name)
    np.testing.assert_array_equal(
        model2.params_to_arrays()["item_embed"][: info.n_items],
        model.params_to_arrays()["item_embed"][: info.n_items])
    model2.fit(new_train, neg_sampling=neg, verbose=0)
    user = new_frame.user.iloc[0]
    assert len(model2.recommend_user(user=user, n_rec=5)[user]) == 5


def test_sparse_optimizer_retrain_grafts_moment_rows(tmp_path):
    frame = make_interactions()
    train, info = DatasetPure.build_trainset(cols(frame))
    model = tmodels.BPR("ranking", info, device="cpu", sparse_optimizer=True, **EMBED)
    model.fit(train, neg_sampling=True, verbose=0)
    model.save(tmp_path, "BPR")
    old_mu = model.trainer.opt_state.table_state["mu"]["user_embed"].numpy()
    assert np.abs(old_mu).sum() > 0
    new_train, new_info = DatasetPure.merge_trainset(cols(_new_data(frame)), info)
    model2 = tmodels.BPR("ranking", new_info, device="cpu", sparse_optimizer=True,
                         **{**EMBED, "n_epochs": 0})
    model2.rebuild_model(tmp_path, "BPR")
    model2.fit(new_train, neg_sampling=True, verbose=0)
    new_mu = model2.trainer.opt_state.table_state["mu"]["user_embed"].numpy()
    np.testing.assert_array_equal(new_mu[: info.n_users], old_mu[: info.n_users])
    model2.n_epochs = 1
    model2.fit(new_train, neg_sampling=True, verbose=0)


@pytest.mark.parametrize("cls_name", ["ALS", "Item2Vec", "DeepWalk", "Swing"])
def test_embed_family_retrain_flow(cls_name, tmp_path):
    kw = dict(top_k=10) if cls_name == "Swing" else dict(embed_size=8, n_epochs=1)
    frame = make_interactions()
    new_frame = _new_data(frame)
    train, info = DatasetPure.build_trainset(cols(frame))
    cls = getattr(tmodels, cls_name)
    model = cls("ranking", info, device="cpu", **kw)
    model.fit(train, neg_sampling=True, verbose=0)
    model.save(tmp_path, cls_name)
    new_train, new_info = DatasetPure.merge_trainset(cols(new_frame), info)
    model2 = cls("ranking", new_info, device="cpu", **kw)
    model2.rebuild_model(tmp_path, cls_name)
    model2.fit(new_train, neg_sampling=True, verbose=0)
    old_user, new_user = frame.user.iloc[0], new_frame.user.iloc[0]
    recs = model2.recommend_user(user=[old_user, new_user], n_rec=5)
    assert len(recs[old_user]) == 5 and len(recs[new_user]) == 5
    if cls_name == "Swing":
        # as in the JAX package, fit ignores the saved state: a fresh fit
        fresh = cls("ranking", new_info, device="cpu", **kw)
        fresh.fit(new_train, neg_sampling=True, verbose=0)
        np.testing.assert_array_equal(model2.sim_ids, fresh.sim_ids)


# ------------------------------------------- grafting and leaves vs JAX
GRAFT_CASES = {
    "bpr-lazy": ("BPR", "pure", {}),
    "bpr-lazy-decay": ("BPR", "pure", dict(lr_decay=True)),
    "bpr-momentum": ("BPR", "pure", dict(optimizer="momentum")),
    "svd": ("SVD", "pure", {}),
    "lightgcn-amsgrad": ("LightGCN", "pure", dict(amsgrad=True)),
    "fm": ("FM", "feat", {}),
    "widedeep": ("WideDeep", "feat", dict(lr={"wide": 0.01, "deep": 1e-3})),
}


def _datasets(kind):
    """(JAX train, info, new train, new info), (port ...), on the tests'
    frames and their second period."""
    from librecommender_tpu import data as jdata

    if kind == "pure":
        frame = make_interactions()
        new_frame = _new_data(frame)
        j_cls, t_cls, kw = jdata.DatasetPure, DatasetPure, {}
    else:
        frame, new_frame = feat_frames()
        j_cls, t_cls, kw = jdata.DatasetFeat, DatasetFeat, FEAT
    j_train, j_info = j_cls.build_trainset(frame, **kw)
    j_new_train, j_new = j_cls.merge_trainset(new_frame, j_info)
    t_train, t_info = t_cls.build_trainset(cols(frame), **kw)
    t_new_train, t_new = t_cls.merge_trainset(cols(new_frame), t_info)
    return (j_train, j_info, j_new_train, j_new), (t_train, t_info, t_new_train, t_new)


@pytest.mark.parametrize("case", list(GRAFT_CASES))
def test_grafted_state_equals_jax(case, tmp_path):
    """One JAX save, rebuilt in both packages on the merged vocabulary from
    the same fresh parameters: grafted parameters and optimizer leaves are
    JAX's bit for bit (a fit of 0 epochs grafts the leaves in both). Then
    the port's save of the same model: its opt-state file rebuilds in JAX
    to the same leaves."""
    import jax

    from librecommender_tpu import models as jmodels

    cls, kind, extra = GRAFT_CASES[case]
    (j_train, j_info, j_new_train, j_new), (_, _, t_new_train, t_new) = _datasets(kind)
    kw = dict(EMBED, **extra)
    jm = getattr(jmodels, cls)("ranking", j_info, **kw)
    jm.fit(j_train, neg_sampling=True, verbose=0)
    jm.save(tmp_path / "jax", cls)
    jm2 = getattr(jmodels, cls)("ranking", j_new, **{**kw, "n_epochs": 0})
    jm2.build_model()
    fresh = jax.device_get(jm2.params)
    jm2.rebuild_model(tmp_path / "jax", cls)
    jm2.fit(j_new_train, neg_sampling=True, verbose=0)
    tm2 = getattr(tmodels, cls)("ranking", t_new, device="cpu",
                                **{**kw, "n_epochs": 0})
    tm2.params_from_arrays(fresh)
    tm2.rebuild_model(tmp_path / "jax", cls)
    same_tree(tm2.params_to_arrays(), jax.device_get(jm2.params))
    tm2.fit(t_new_train, neg_sampling=True, verbose=0)
    same_leaves(tm2.trainer.opt_state_leaves(), jax_leaves(jm2.trainer.opt_state))



@pytest.mark.parametrize("case", ["svd", "bpr-lazy-decay", "lightgcn-amsgrad",
                                  "widedeep"])
def test_checkpoints_and_opt_state_cross_package(case, tmp_path):
    """JAX's checkpoint resumes in the port (parameters, then the restored
    leaves, bit for bit); the port's checkpoint after one more epoch resumes
    in JAX the same way, and the port's opt-state file holds those leaves
    for JAX's reader."""
    import jax

    from librecommender_tpu import models as jmodels
    from librecommender_tpu.utils.save_load import load_opt_state

    cls, kind, extra = GRAFT_CASES[case]
    (j_train, j_info, _, _), (t_train, t_info, _, _) = _datasets(kind)
    kw = dict(EMBED, **extra)
    jm = getattr(jmodels, cls)("ranking", j_info, **kw)
    jm.fit(j_train, neg_sampling=True, verbose=0, checkpoint_dir=tmp_path / "jax")
    tm = getattr(tmodels, cls)("ranking", t_info, device="cpu", **{**kw, "n_epochs": 0})
    assert tm.load_checkpoint(tmp_path / "jax") == 1
    same_tree(tm.params_to_arrays(), jax.device_get(jm.params))
    tm.fit(t_train, neg_sampling=True, verbose=0)
    same_leaves(tm.trainer.opt_state_leaves(), jax_leaves(jm.trainer.opt_state))

    tm.n_epochs = 1
    tm.fit(t_train, neg_sampling=True, verbose=0, checkpoint_dir=tmp_path / "torch")
    tm.save(tmp_path / "saved", cls)
    port_leaves = tm.trainer.opt_state_leaves()
    fmt, saved = load_opt_state(tmp_path / "saved", cls)
    same_leaves(opt_leaves_from_jax(saved), port_leaves)
    jm2 = getattr(jmodels, cls)("ranking", j_info, **{**kw, "n_epochs": 0})
    assert jm2.load_checkpoint(tmp_path / "torch") == 1
    same_tree(jax.device_get(jm2.params), tm.params_to_arrays())
    jm2.fit(j_train, neg_sampling=True, verbose=0)
    same_leaves(jax_leaves(jm2.trainer.opt_state), port_leaves)


# case -> tolerance, relative to each leaf's largest magnitude; WideDeep's
# MLP spreads rounding as in test_torch_feat_models' fits (parameters there
# within rtol 1e-4 plus 1e-5), its moments here within 1e-3
LEAF_CASES = {"bpr-lazy": 1e-4, "bpr-momentum": 1e-4, "svd": 1e-4,
              "lightgcn-amsgrad": 1e-4, "fm": 1e-4, "widedeep": 1e-3}


@pytest.mark.parametrize("case", list(LEAF_CASES))
def test_leaves_after_one_epoch_match_jax(case):
    """From JAX's initial parameters on the same batches, each optimizer
    leaf after one epoch is JAX's leaf at the same position: the mapping of
    the port's optimizer state onto optax's leaf order, held value by value
    (within 1e-4 of each leaf's largest magnitude, WideDeep 1e-3: a step's
    rounding moves a moment near zero by more than its own relative
    tolerance)."""
    import jax

    from librecommender_tpu import models as jmodels

    cls, kind, extra = GRAFT_CASES[case]
    (j_train, j_info, _, _), (t_train, t_info, _, _) = _datasets(kind)
    kw = dict(EMBED, sampler="unconsumed", **extra)
    jm = getattr(jmodels, cls)("ranking", j_info, **kw)
    jm.build_model()
    tm = getattr(tmodels, cls)("ranking", t_info, device="cpu", **kw)
    tm.params_from_arrays(jax.device_get(jm.params))
    jm.fit(j_train, neg_sampling=True, verbose=0, shuffle=False)
    tm.fit(t_train, neg_sampling=True, verbose=0, shuffle=False)
    want = jax_leaves(jm.trainer.opt_state)
    got = tm.trainer.opt_state_leaves()
    same_leaves(got, want, rtol=LEAF_CASES[case])
    assert any(np.abs(w).sum() > 0 for w in want if np.ndim(w))
