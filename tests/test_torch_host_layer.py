"""The port's host-layer functions against the JAX package's on the CPU:
``process_data`` (numpy copies of scikit-learn's four scalers) and
``split_multi_value``, ``split_by_num`` / ``split_by_num_chrono``,
``BatchGenerator.__call__``, the validate helpers, the model-family enums
and ``NotSamplingError``.

Tolerances: ``process_data``'s columns rtol 1e-6 (atol 1e-6 for entries
near zero) under "min_max", "standard" and "robust", rtol 1e-5 (atol 1e-5)
under "power" (its lambda is a numerical optimum); everything else exactly.
"""
import numpy as np
import pytest

from librecommender_tpu_torch.batch.generator import BatchGenerator
from librecommender_tpu_torch.data import (
    DatasetFeat,
    DatasetPure,
    process_data,
    split_by_num,
    split_by_num_chrono,
    split_multi_value,
)
from librecommender_tpu_torch.utils import constants, exceptions, validate

# the frames are pandas' and the reference is the JAX package's (neither is
# on the GPU host, where this file has no test to run)
pd = pytest.importorskip("pandas")
pytest.importorskip("librecommender_tpu.data")


def cols(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


def dense_frames(seed=0):
    """A train and a test frame: a skewed positive float column, a column
    with negative values, an integer column and a constant one."""
    rng = np.random.default_rng(seed)

    def frame(n):
        return pd.DataFrame({
            "user": rng.integers(0, 20, n),
            "price": rng.lognormal(1.0, 0.8, n),
            "delta": rng.normal(0.5, 2.0, n),
            "count": rng.integers(0, 50, n),
            "flat": np.full(n, 3.0),
        })

    return frame(200), frame(80)


@pytest.mark.parametrize("normalizer", ["min_max", "standard", "robust", "power"])
@pytest.mark.parametrize("transformer", [("log", "sqrt", "square"), ("sqrt",), None])
def test_process_data_matches_jax(normalizer, transformer):
    from librecommender_tpu.data import process_data as j_process_data

    dense = ["price", "delta", "count", "flat"]
    j_frames = list(dense_frames())
    t_frames = [cols(f) for f in j_frames]
    _, j_cols = j_process_data(j_frames, dense_col=list(dense),
                               normalizer=normalizer, transformer=transformer)
    out, t_cols = process_data(t_frames, dense_col=list(dense),
                               normalizer=normalizer, transformer=transformer)
    assert out is t_frames and t_cols == j_cols
    tol = 1e-5 if normalizer == "power" else 1e-6
    for j_frame, t_frame in zip(j_frames, t_frames):
        assert list(t_frame) == list(j_frame.columns)
        for c in j_frame.columns:
            want = j_frame[c].to_numpy()
            assert t_frame[c].dtype == want.dtype, c
            np.testing.assert_allclose(t_frame[c], want, rtol=tol, atol=tol,
                                       err_msg=c)


def test_process_data_rejects_bad_arguments():
    with pytest.raises(ValueError):
        process_data(cols(dense_frames()[0]), dense_col="price")
    with pytest.raises(ValueError):
        process_data(cols(dense_frames()[0]), dense_col=["price"], normalizer="x")


def multi_value_frame():
    return pd.DataFrame({
        "user": [1, 2, 3, 4, 5, 6],
        "genre": ["Action|Comedy", " drama | Crime|", "", None, "A B|c", "|x|"],
        "tag": ["a,b,c,d", "b", "c,,d", "x", "", "y,z"],
        "rating": [1.0, np.nan, 3.0, 4.0, 5.0, 2.0],
    })


@pytest.mark.parametrize("kw", [
    dict(multi_value_col=["genre"], sep="|"),
    dict(multi_value_col=["genre", "tag"], sep="|", max_len=[2, 3],
         pad_val=["missing", "none"], user_col=["tag"], item_col=["genre"]),
    dict(multi_value_col=["tag"], sep=",", item_col=["tag"]),
    # a separator longer than one character is a regular expression
    dict(multi_value_col=["genre"], sep=r"\|", pad_val="?"),
])
def test_split_multi_value_matches_jax(kw):
    from librecommender_tpu.data import split_multi_value as j_split

    j_data, *j_names = j_split(multi_value_frame(), **kw)
    t_data, *t_names = split_multi_value(cols(multi_value_frame()), **kw)
    assert t_names == j_names
    assert list(t_data) == list(j_data.columns)
    for c in j_data.columns:
        assert list(t_data[c]) == list(j_data[c]), c


def chrono_frame(seed=0, n=400):
    """Interactions with many tied times."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "user": rng.integers(0, 40, n),
        "item": rng.integers(0, 60, n),
        "label": rng.integers(1, 6, n).astype(np.float32),
        "time": rng.integers(0, 30, n),
    })


SPLIT_KW = [dict(), dict(test_size=2), dict(test_size=5, shuffle=True, seed=3),
            dict(order=False)]
UNKNOWN_KW = [dict(filter_unknown=False),
              dict(filter_unknown=False, pad_unknown=True, pad_val=-1)]


@pytest.mark.parametrize("chrono,kw", [(False, kw) for kw in SPLIT_KW + UNKNOWN_KW]
                         + [(True, kw) for kw in SPLIT_KW])
def test_split_by_num_matches_jax(chrono, kw):
    from librecommender_tpu.data import split_by_num as j_num
    from librecommender_tpu.data import split_by_num_chrono as j_num_chrono

    if chrono:
        j_parts = j_num_chrono(chrono_frame(), **kw)
        t_parts = split_by_num_chrono(cols(chrono_frame()), **kw)
    else:
        j_parts = j_num(chrono_frame(), **kw)
        t_parts = split_by_num(cols(chrono_frame()), **kw)
    assert len(t_parts) == len(j_parts) == 2
    for t, j in zip(t_parts, j_parts):
        for c in j.columns:
            np.testing.assert_array_equal(t[c], j[c].to_numpy(), err_msg=c)


def test_split_by_num_rejects_bad_sizes():
    data = cols(chrono_frame())
    for size in (0, 400, 1.5):
        with pytest.raises(ValueError):
            split_by_num(data, test_size=size)
    with pytest.raises(ValueError):
        split_by_num_chrono({"user": data["user"]})


@pytest.mark.parametrize("paradigm,sampler,shuffle", [
    ("pointwise", "random", True),
    ("pointwise", "popular", True),
    ("pairwise", "unconsumed", False),
    ("listwise", None, True),
])
def test_batch_generator_call_matches_jax(pure_frames, paradigm, sampler, shuffle):
    from librecommender_tpu.batch.generator import BatchGenerator as JGenerator
    from librecommender_tpu.data import DatasetPure as JDatasetPure

    train = pure_frames[0]
    j_train, j_info = JDatasetPure.build_trainset(train)
    t_train, t_info = DatasetPure.build_trainset(cols(train))
    extras = {"seq": np.arange(len(train)) % 7}
    kw = dict(batch_size=300, paradigm=paradigm,
              neg_sampling=sampler is not None, sampler=sampler or "random",
              num_neg=2, seed=11, extras=extras)
    j_gen = JGenerator(j_train, j_info, **kw)
    t_gen = BatchGenerator(t_train, t_info, **kw)
    for _ in range(2):   # two epochs: the rng carries over
        j_batches = list(j_gen(shuffle=shuffle))
        t_batches = list(t_gen(shuffle=shuffle))
        assert len(t_batches) == len(j_batches) == t_gen.n_batches()
        for t, j in zip(t_batches, j_batches):
            assert sorted(t) == sorted(j)
            for key in j:
                assert t[key].dtype == j[key].dtype, key
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def test_validate_helpers_match_jax(feat_frames):
    from librecommender_tpu.data import DatasetFeat as JDatasetFeat
    from librecommender_tpu.utils import validate as jvalidate

    train = feat_frames[0]
    kw = dict(user_col=["sex", "age"], item_col=["genre"],
              sparse_col=["sex", "genre"], dense_col=["age"])
    j_info = JDatasetFeat.build_trainset(train, **kw)[1]
    t_info = DatasetFeat.build_trainset(cols(train), **kw)[1]
    for fn in ("check_sparse_indices", "check_dense_values",
               "sparse_field_size", "dense_field_size", "sparse_feat_size"):
        assert getattr(validate, fn)(t_info) == getattr(jvalidate, fn)(j_info), fn
    for combiner in (None, "sum", "mean"):
        assert (validate.check_multi_sparse(t_info, combiner)
                == jvalidate.check_multi_sparse(j_info, combiner))
    t_info.multi_sparse_combine_info = {"x": 1}   # a data set with such fields
    assert validate.check_multi_sparse(t_info, "sqrtn") == "sqrtn"
    with pytest.raises(ValueError, match="unsupported"):
        validate.check_multi_sparse(t_info, "max")


def test_enums_and_exception_match_jax():
    from librecommender_tpu.utils import constants as jconstants
    from librecommender_tpu.utils import exceptions as jexceptions

    names = [n for n, v in vars(jconstants).items()
             if isinstance(v, type) and issubclass(v, jconstants.StrEnum)
             and v is not jconstants.StrEnum]
    assert len(names) == 6
    for name in names:
        port, jax_ = getattr(constants, name), getattr(jconstants, name)
        assert [(m.name, m.value) for m in port] == [(m.name, m.value) for m in jax_]
    assert constants.EmbeddingModels.contains("BPR")
    assert not constants.FeatModels.contains("BPR")
    assert constants.SequenceModels.DIN == "DIN"
    assert issubclass(exceptions.NotSamplingError, Exception)
    with pytest.raises(exceptions.NotSamplingError, match="sampling"):
        raise exceptions.NotSamplingError("needs negative sampling")
    assert exceptions.NotSamplingError.__doc__ == jexceptions.NotSamplingError.__doc__
