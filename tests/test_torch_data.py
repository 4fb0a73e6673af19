"""The port's data pipeline and metrics against the JAX package.

Same frames into both packages (the port gets them as column dicts and as
DataFrames); everything must come out exactly equal: consumed lists and
their key order, inner ids, shuffles, splits (tied times included), epoch
arrays and host negatives, eval negatives. Metrics: numpy/scipy against the
JAX package's scikit-learn ones, rtol 1e-9. The card's machine has no
pandas, so this file imports it only inside the tests.
"""
import numpy as np
import pytest


def _cols(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


def _assert_same_rows(got, want):
    """A port split (dict or DataFrame) holds exactly ``want``'s rows."""
    assert list(got.keys()) == list(want.columns)
    for c in want.columns:
        np.testing.assert_array_equal(np.asarray(got[c]), want[c].to_numpy())
    if hasattr(got, "iloc"):
        np.testing.assert_array_equal(got.index.to_numpy(), want.index.to_numpy())


def _assert_same_builds(port, jax_):
    (pt, pinfo), (jt, jinfo) = port, jax_
    np.testing.assert_array_equal(pt.user_indices, jt.user_indices)
    np.testing.assert_array_equal(pt.item_indices, jt.item_indices)
    np.testing.assert_array_equal(pt.labels, jt.labels)
    assert pt.labels.dtype == jt.labels.dtype
    assert (pt.sparse_interaction != jt.sparse_interaction).nnz == 0
    assert pt.sparse_interaction.shape == jt.sparse_interaction.shape
    np.testing.assert_array_equal(pinfo.user_unique_vals, jinfo.user_unique_vals)
    np.testing.assert_array_equal(pinfo.item_unique_vals, jinfo.item_unique_vals)
    for attr in ("user_consumed", "item_consumed"):
        assert list(getattr(pinfo, attr).items()) == list(getattr(jinfo, attr).items())
    np.testing.assert_array_equal(pinfo.interaction_data.to_numpy(),
                                  jinfo.interaction_data.to_numpy())
    assert pinfo.interaction_data.to_numpy().dtype == jinfo.interaction_data.to_numpy().dtype
    assert pinfo.popular_items == jinfo.popular_items


def test_interaction_consumed_matches_jax():
    from librecommender_tpu.data.consumed import interaction_consumed as jax_ic
    from librecommender_tpu_torch.data.consumed import interaction_consumed

    rng = np.random.default_rng(0)
    users = rng.integers(0, 30, 2000)
    items = rng.integers(0, 8, 2000)       # many consecutive repeats
    users[100:110] = 7
    items[100:110] = 3
    for got, want in zip(interaction_consumed(users, items), jax_ic(users, items)):
        assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("as_frame", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataset_pure_matches_jax(pure_frames, as_frame, shuffle):
    from librecommender_tpu.data import DatasetPure as JaxDatasetPure
    from librecommender_tpu_torch.data import DatasetPure

    train, evals, test = pure_frames
    conv = (lambda f: f) if as_frame else _cols
    jax_ = JaxDatasetPure.build_trainset(train, shuffle=shuffle, seed=3)
    port = DatasetPure.build_trainset(conv(train), shuffle=shuffle, seed=3)
    _assert_same_builds(port, jax_)
    for frame in (evals, test):
        je = JaxDatasetPure.build_evalset(frame)
        pe = DatasetPure.build_testset(conv(frame))
        np.testing.assert_array_equal(pe.user_indices, je.user_indices)
        np.testing.assert_array_equal(pe.item_indices, je.item_indices)
        np.testing.assert_array_equal(pe.labels, je.labels)
        assert list(pe.positive_consumed.items()) == list(je.positive_consumed.items())


@pytest.mark.parametrize("n_ids", [40, 300])  # below and above the hash-coding cut
def test_string_ids_match_jax(n_ids):
    import pandas as pd

    from librecommender_tpu.data import DatasetPure as JaxDatasetPure
    from librecommender_tpu_torch.data import DatasetPure

    rng = np.random.default_rng(1)
    n = 3000
    frame = pd.DataFrame({
        "user": np.array([f"u{i}" for i in rng.integers(0, n_ids, n)], dtype=object),
        "item": np.array([f"i{i}" for i in rng.integers(0, 2 * n_ids, n)], dtype=object),
        "label": rng.integers(1, 6, n).astype(np.float64),
    })
    train, unseen = frame.iloc[:2500], frame.iloc[2500:].copy()
    unseen.iloc[:5, 0] = "never-seen"
    port = DatasetPure.build_trainset(_cols(train))
    _assert_same_builds(port, JaxDatasetPure.build_trainset(train))
    assert port[1].interaction_data.to_numpy().dtype == object
    pe = DatasetPure.build_testset(_cols(unseen))
    je = JaxDatasetPure.build_testset(unseen)
    np.testing.assert_array_equal(pe.user_indices, je.user_indices)
    np.testing.assert_array_equal(pe.item_indices, je.item_indices)


def test_shuffle_data_is_pandas_sample(pure_frames):
    from librecommender_tpu_torch.data.dataset import DatasetPure

    frame = pure_frames[0]
    want = frame.sample(frac=1, random_state=11).reset_index(drop=True)
    _assert_same_rows(DatasetPure.shuffle_data(_cols(frame), 11), want)
    _assert_same_rows(DatasetPure.shuffle_data(frame, 11), want)


def _split_frame():
    import pandas as pd

    rng = np.random.default_rng(2)
    n = 3000
    return pd.DataFrame({
        "user": rng.integers(0, 80, n) + 10,
        "item": rng.integers(0, 150, n) + 500,
        "label": rng.integers(1, 6, n).astype(np.float64),
        "time": rng.integers(0, 40, n),    # heavily tied times
    })


SPLITS = [
    ("random_split", dict(multi_ratios=[0.8, 0.1, 0.1], seed=4)),
    ("random_split", dict(test_size=0.25, shuffle=False)),
    ("random_split", dict(test_size=0.3, filter_unknown=False, pad_unknown=True,
                          pad_val=-1)),
    ("split_by_ratio", dict(test_size=0.2)),
    ("split_by_ratio", dict(multi_ratios=[0.7, 0.2, 0.1], shuffle=True, seed=5)),
    ("split_by_ratio", dict(test_size=0.2, order=False, filter_unknown=False)),
    ("split_by_ratio_chrono", dict(test_size=0.2)),
    ("split_by_ratio_chrono", dict(multi_ratios=[0.6, 0.2, 0.2], shuffle=True)),
]


@pytest.mark.parametrize("as_frame", [False, True])
@pytest.mark.parametrize("name,kwargs", SPLITS)
def test_splits_match_jax(name, kwargs, as_frame):
    import librecommender_tpu.data.split as jax_split
    import librecommender_tpu_torch.data.split as port_split

    frame = _split_frame()
    if name == "split_by_ratio_chrono":
        # the time sort is unstable: tied times must land as pandas puts them
        ties = frame.sort_values(by=["time"]).index.to_numpy()
        assert not (np.diff(ties[frame["time"].to_numpy()[ties] == 7]) > 0).all()
    want = getattr(jax_split, name)(frame, **kwargs)
    got = getattr(port_split, name)(frame if as_frame else _cols(frame), **kwargs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same_rows(g, w)


@pytest.mark.parametrize("sampler", ["unconsumed", "popular", "random"])
def test_batch_generator_matches_jax(pure_frames, pure_builds, sampler):
    from librecommender_tpu.batch import BatchGenerator as JaxBatchGenerator
    from librecommender_tpu_torch.batch import BatchGenerator
    from librecommender_tpu_torch.data import DatasetPure

    train_data, _, _, jinfo = pure_builds
    ptrain, pinfo = DatasetPure.build_trainset(_cols(pure_frames[0]))
    kw = dict(batch_size=128, paradigm="pairwise", neg_sampling=True,
              sampler=sampler, num_neg=2, seed=9)
    jg = JaxBatchGenerator(train_data, jinfo, **kw)
    pg = BatchGenerator(ptrain, pinfo, **kw)
    assert pg.n_batches() == jg.n_batches()
    assert pg.device_side_sampling == jg.device_side_sampling
    for k, v in jg.epoch_arrays().items():
        got = pg.epoch_arrays()[k]
        np.testing.assert_array_equal(got, v)
        assert got.dtype == v.dtype
    for _ in range(2):  # two epochs: the generators advance alike
        jn, pn = jg.epoch_negatives(), pg.epoch_negatives()
        if jn is None:
            assert pn is None
        else:
            np.testing.assert_array_equal(pn, jn)
            assert pn.dtype == jn.dtype and pn.shape == (pg.n_batches() * 128, 2)


def test_adjust_batch_size_matches_jax():
    from librecommender_tpu.batch import adjust_batch_size as jax_adjust
    from librecommender_tpu_torch.batch import adjust_batch_size

    class M:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    for m in (M(paradigm="pairwise", sampler="random", num_neg=3, loss_type="bpr"),
              M(paradigm="pointwise", sampler="random", num_neg=1,
                loss_type="cross_entropy"),
              M(paradigm="listwise", sampler=None), M(paradigm="pointwise", sampler=None)):
        assert adjust_batch_size(m, 1000) == jax_adjust(m, 1000)


def test_eval_negatives_match_jax(pure_builds):
    from librecommender_tpu_torch.data import TransformedEvalSet

    _, eval_data, _, jinfo = pure_builds
    port = TransformedEvalSet(eval_data.user_indices, eval_data.item_indices,
                              eval_data.labels)
    assert list(port.positive_consumed.items()) == list(eval_data.positive_consumed.items())
    eval_data.build_negatives(jinfo.n_items, num_neg=2, seed=2222)
    port.build_negatives(jinfo.n_items, num_neg=2, seed=2222)
    for attr in ("user_indices", "item_indices", "labels"):
        np.testing.assert_array_equal(getattr(port, attr), getattr(eval_data, attr))
        assert getattr(port, attr).dtype == getattr(eval_data, attr).dtype


# ----------------------------------------------------------------- metrics
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pointwise_and_rating_metrics_match_sklearn(dtype):
    from librecommender_tpu.evaluation import metrics as jm
    from librecommender_tpu_torch.evaluation import metrics as pm

    rng = np.random.default_rng(3)
    n = 5000
    labels = (rng.random(n) < 0.3).astype(np.float32)
    probs = np.round(rng.random(n), 2).astype(dtype)   # many tied scores
    probs[:50] = 0.0
    probs[50:100] = 1.0
    users = rng.integers(0, 40, n)
    for name in ("roc_auc", "pr_auc", "balanced_accuracy"):
        np.testing.assert_allclose(getattr(pm, name)(labels, probs),
                                   getattr(jm, name)(labels, probs), rtol=1e-9,
                                   err_msg=name)
    clipped = np.clip(probs, 1e-7, 1 - 1e-7)
    np.testing.assert_allclose(pm.binary_log_loss(labels, clipped),
                               jm.binary_log_loss(labels, clipped), rtol=1e-9)
    np.testing.assert_allclose(pm.roc_gauc(labels, probs, users),
                               jm.roc_gauc(labels, probs, users), rtol=1e-9)
    ratings = rng.integers(1, 6, n).astype(dtype)
    preds = (ratings + rng.normal(size=n)).astype(dtype)
    for name in ("rmse", "mae", "r2"):
        np.testing.assert_allclose(getattr(pm, name)(ratings, preds),
                                   getattr(jm, name)(ratings, preds), rtol=1e-9,
                                   err_msg=name)
    assert pm.r2(np.ones(5), np.ones(5)) == jm.r2(np.ones(5), np.ones(5))
    with pytest.raises(ValueError):
        pm.roc_auc(np.ones(5), probs[:5])
