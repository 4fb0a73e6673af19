"""The feature data pipeline of the PyTorch port against the JAX package.

Both packages build the same frames (the ``tests/conftest.py`` feature frame,
and a multi-sparse one made here); the port takes them as column dicts, since
it has no pandas. Indices, unique tables, offsets and OOVs must be equal
exactly: they are integers and copied floats, computed by the same rules.
"""
import numpy as np
import pytest
import torch

# a machine with the GPU and without JAX or pandas skips this file
pd = pytest.importorskip("pandas")
pytest.importorskip("jax")
pytest.importorskip("librecommender_tpu.data")

from librecommender_tpu.batch import BatchGenerator as JBatchGenerator
from librecommender_tpu.batch.sequence import build_train_seqs as j_train_seqs
from librecommender_tpu.batch.sequence import get_recent_seqs as j_recent_seqs
from librecommender_tpu.data import DataInfo as JDataInfo
from librecommender_tpu.data import DatasetFeat as JDatasetFeat
from librecommender_tpu.ops.features import FeatureTables as JFeatureTables
from librecommender_tpu.utils import validate as j_validate
from librecommender_tpu_torch.batch import BatchGenerator
from librecommender_tpu_torch.batch.sequence import build_train_seqs, get_recent_seqs
from librecommender_tpu_torch.data import DataInfo, DatasetFeat
from librecommender_tpu_torch.ops.features import FeatureTables
from librecommender_tpu_torch.utils import validate

FEAT_COLS = dict(user_col=["sex", "age"], item_col=["genre"],
                 sparse_col=["sex", "genre"], dense_col=["age"])
TABLES = ("user_sparse_unique", "item_sparse_unique", "user_dense_unique",
          "item_dense_unique", "sparse_offset", "sparse_oov")
SET_FIELDS = ("user_indices", "item_indices", "labels", "sparse_indices",
              "dense_values")


def as_columns(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


def _same(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _multi_sparse_frames():
    rng = np.random.default_rng(5)
    n = 900
    frame = pd.DataFrame({
        "user": rng.integers(0, 40, n) + 100,
        "item": rng.integers(0, 60, n) + 7000,
        "label": np.ones(n),
    }).drop_duplicates(subset=["user", "item"]).reset_index(drop=True)
    genres = np.array(["a", "b", "c", "d", "e", "missing"])
    per_item = {i: rng.choice(genres, 3) for i in frame.item.unique()}
    for j in range(3):
        frame[f"genre{j + 1}"] = frame.item.map(lambda i, j=j: per_item[i][j])
    frame["sex"] = frame.user.map({u: rng.choice(["m", "f"])
                                   for u in frame.user.unique()})
    frame["year"] = frame.item.map({i: int(rng.integers(1990, 2000))
                                    for i in frame.item.unique()})
    frame["age"] = frame.user.map({u: float(rng.normal())
                                   for u in frame.user.unique()})
    cut = int(0.8 * len(frame))
    train = frame.iloc[:cut].reset_index(drop=True)
    evals = frame.iloc[cut:].reset_index(drop=True)
    evals.loc[0, "user"] = 99_999  # an unseen user and an unseen item
    evals.loc[1, "item"] = 99
    return train, evals


MULTI_COLS = dict(user_col=["sex", "age"],
                  item_col=["year", "genre1", "genre2", "genre3"],
                  sparse_col=["sex", "year"], dense_col=["age"],
                  multi_sparse_col=[["genre1", "genre2", "genre3"]])


def _frames(kind, feat_frames):
    if kind == "conftest":
        train, evals, _ = feat_frames
        return train, evals, FEAT_COLS
    train, evals = _multi_sparse_frames()
    return train, evals, MULTI_COLS


def _build_both(kind, feat_frames, **extra):
    train, evals, cols = _frames(kind, feat_frames)
    j_train, j_info = JDatasetFeat.build_trainset(train, **cols, **extra)
    j_eval = JDatasetFeat.build_evalset(evals)
    t_train, t_info = DatasetFeat.build_trainset(as_columns(train), **cols, **extra)
    t_eval = DatasetFeat.build_evalset(as_columns(evals))
    return (j_train, j_eval, j_info), (t_train, t_eval, t_info)


@pytest.mark.parametrize("kind", ["conftest", "multi_sparse"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataset_feat_matches_jax(feat_frames, kind, shuffle):
    (j_train, j_eval, j_info), (t_train, t_eval, t_info) = _build_both(
        kind, feat_frames, shuffle=shuffle, seed=11)
    for f in SET_FIELDS:
        _same(getattr(j_train, f), getattr(t_train, f), f"train {f}")
    for f in TABLES:
        _same(getattr(j_info, f), getattr(t_info, f), f)
    for f in ("user_indices", "item_indices", "labels"):
        _same(getattr(j_eval, f), getattr(t_eval, f), f"eval {f}")
    if kind == "multi_sparse":  # unseen ids map to the OOV id
        assert t_eval.user_indices[0] == t_info.n_users
        assert t_eval.item_indices[1] == t_info.n_items
    assert j_info.col_name_mapping == t_info.col_name_mapping
    for fam in ("sparse_col", "dense_col", "user_sparse_col", "user_dense_col",
                "item_sparse_col", "item_dense_col"):
        assert getattr(j_info, fam) == getattr(t_info, fam), fam
    assert j_info.sparse_idx_mapping == t_info.sparse_idx_mapping
    assert t_info.feature_version == 0
    assert j_info.user_consumed == t_info.user_consumed
    assert (j_info.n_users, j_info.n_items) == (t_info.n_users, t_info.n_items)
    j_ms, t_ms = j_info.multi_sparse_combine_info, t_info.multi_sparse_combine_info
    assert (j_ms is None) == (t_ms is None) == (kind == "conftest")
    if j_ms is not None:
        assert list(j_ms.field_offset) == list(t_ms.field_offset)
        assert list(j_ms.field_len) == list(t_ms.field_len)
        _same(j_ms.feat_oov, t_ms.feat_oov, "feat_oov")
        assert j_ms.pad_val == t_ms.pad_val
    assert j_validate.sparse_feat_size(j_info) == validate.sparse_feat_size(t_info)


def test_dataset_feat_takes_a_dataframe_too(feat_frames):
    train, _, _ = feat_frames
    a, a_info = DatasetFeat.build_trainset(train, **FEAT_COLS)
    b, b_info = DatasetFeat.build_trainset(as_columns(train), **FEAT_COLS)
    for f in SET_FIELDS:
        _same(getattr(a, f), getattr(b, f), f)
    for f in TABLES:
        _same(getattr(a_info, f), getattr(b_info, f), f)


def test_dataset_feat_rejects_mismatched_columns(feat_frames):
    train = as_columns(feat_frames[0])
    with pytest.raises(ValueError, match="length of columns"):
        DatasetFeat.build_trainset(train, user_col=["sex"], item_col=["genre"],
                                   sparse_col=["sex", "genre"], dense_col=["age"])
    with pytest.raises(ValueError, match="inconsistent columns"):
        DatasetFeat.build_trainset(train, user_col=["sex", "age"], item_col=["nope"],
                                   sparse_col=["sex", "genre"], dense_col=["age"])
    with pytest.raises(ValueError, match="first two columns"):
        DatasetFeat.build_trainset({"item": train["item"], "user": train["user"],
                                    "label": train["label"]})


@pytest.mark.parametrize("kind", ["conftest", "multi_sparse"])
@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_feature_data_info_crosses_packages(feat_frames, tmp_path, kind, saver):
    (_, _, j_info), (_, _, t_info) = _build_both(kind, feat_frames)
    (j_info if saver == "jax" else t_info).save(tmp_path, "m")
    loaded = [DataInfo.load(tmp_path, "m"), JDataInfo.load(tmp_path, "m")]
    for info in loaded:
        for f in TABLES:
            _same(getattr(j_info, f), getattr(info, f), f)
        assert info.col_name_mapping == j_info.col_name_mapping
        assert info.user_consumed == j_info.user_consumed
        assert info.sparse_idx_mapping == j_info.sparse_idx_mapping
        ms = info.multi_sparse_combine_info
        if kind == "multi_sparse":
            assert list(ms.field_len) == [3] and list(ms.field_offset) == [2]
            _same(ms.feat_oov, j_info.multi_sparse_combine_info.feat_oov, "feat_oov")
        else:
            assert ms is None


@pytest.mark.parametrize("mode", ["recent", "random"])
def test_sequences_match_jax(feat_frames, mode):
    (j_train, _, j_info), (t_train, _, t_info) = _build_both("conftest", feat_frames)
    want = j_train_seqs(j_train.user_indices, j_train.item_indices,
                        j_info.n_items, 5, mode=mode, seed=9)
    got = build_train_seqs(t_train.user_indices, t_train.item_indices,
                           t_info.n_items, 5, mode=mode, seed=9)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert (got[0] == t_info.n_items).all(axis=1).any()  # all-pad histories exist
    want = j_recent_seqs(j_info.n_users, j_info.user_consumed, j_info.n_items, 5)
    got = get_recent_seqs(t_info.n_users, t_info.user_consumed, t_info.n_items, 5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert (got[0][-1] == t_info.n_items).all()  # the cold user's row


def test_seq_mode_contract():
    for args in ((7, None), (None, 4), (None, None), (3, 9)):
        assert validate.check_seq_mode(*args) == j_validate.check_seq_mode(*args)
    with pytest.raises(TypeError):
        validate.check_seq_mode(2.5, None)


def test_batch_generator_extras_match_jax(feat_frames):
    (j_train, _, j_info), (t_train, _, t_info) = _build_both("conftest", feat_frames)
    seqs, _ = build_train_seqs(t_train.user_indices, t_train.item_indices,
                               t_info.n_items, 5)
    kw = dict(paradigm="pointwise", neg_sampling=True, sampler="unconsumed",
              num_neg=2, seed=4)
    want = JBatchGenerator(j_train, j_info, 256, extras={"seq": seqs}, **kw)
    got = BatchGenerator(t_train, t_info, 256, extras={"seq": seqs}, **kw)
    a, b = want.epoch_arrays(), got.epoch_arrays()
    assert sorted(a) == sorted(b) == ["item", "label", "seq", "user", "weight"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert b["seq"].shape == (got.n_batches() * 256, 5)
    np.testing.assert_array_equal(want.epoch_negatives(), got.epoch_negatives())


@pytest.mark.parametrize("kind", ["conftest", "multi_sparse"])
def test_feature_tables_match_jax(feat_frames, kind):
    import jax.numpy as jnp

    (_, _, j_info), (_, _, t_info) = _build_both(kind, feat_frames)
    want, got = JFeatureTables(j_info), FeatureTables(t_info, "cpu")
    for attr in ("n_sparse_fields", "n_dense_fields", "sparse_vocab",
                 "user_sparse_pos", "item_sparse_pos", "user_dense_pos",
                 "item_dense_pos", "has_sparse", "has_dense", "version"):
        assert getattr(want, attr) == getattr(got, attr), attr
    rng = np.random.default_rng(0)
    users = rng.integers(0, t_info.n_users + 1, 64)  # the OOV rows too
    items = rng.integers(0, t_info.n_items + 1, 64)
    for fn in ("sparse_for", "dense_for"):
        a = getattr(want, fn)(jnp.asarray(users), jnp.asarray(items))
        b = getattr(got, fn)(torch.from_numpy(users), torch.from_numpy(items))
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    feats = {"sex": "m", "age": 0.25, "unknown": 1}
    np.testing.assert_array_equal(want.build_user_sparse_row(3, feats),
                                  got.build_user_sparse_row(3, feats))
    np.testing.assert_array_equal(want.build_user_dense_row(3, feats),
                                  got.build_user_dense_row(3, feats))
    np.testing.assert_array_equal(
        want.build_user_sparse_row(3, {"sex": "never seen"}),
        got.build_user_sparse_row(3, {"sex": "never seen"}))
