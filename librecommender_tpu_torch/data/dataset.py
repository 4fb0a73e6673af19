"""From raw columns to a TransformedSet and its DataInfo.

Counterpart of ``DatasetPure`` and ``DatasetFeat`` in
``librecommender_tpu/data/dataset.py`` (``build_trainset``,
``build_evalset``, ``build_testset``), without pandas: the data is any column
mapping (see ``columns.py``) whose first two columns are ``user`` and
``item``. Class-level state carries the unique values from the train build to
later eval/test builds, as in the JAX package. ``merge_*`` (retraining on an
enlarged vocabulary) waits for the retrain slice.
"""
import numpy as np

from .columns import column, column_names, n_rows, take_rows
from .consumed import interaction_consumed
from .data_info import DataInfo
from .transformed import TransformedEvalSet, TransformedSet
from ..feature.column_mapping import col_name2index
from ..feature.multi_sparse import get_multi_sparse_info, multi_sparse_col_map
from ..feature.sparse import (
    get_id_indices,
    get_oov_pos,
    merge_offset,
    merge_sparse_col,
    merge_sparse_indices,
)
from ..feature.unique import construct_unique_feat


class _Dataset:
    user_unique_vals = None
    item_unique_vals = None
    train_called = False

    @staticmethod
    def _check_col_names(data, is_train):
        names = column_names(data)
        if not (len(names) > 1 and names[0] == "user" and names[1] == "item"):
            raise ValueError("'user', 'item' must be the first two columns of the data")
        if is_train and "label" not in names:
            raise ValueError("train data should contain label column")

    @staticmethod
    def shuffle_data(data, seed):
        """The rows in the order of pandas' ``sample(frac=1,
        random_state=seed)``, which is ``RandomState(seed).permutation``."""
        perm = np.random.RandomState(seed).permutation(n_rows(data))
        return take_rows(data, perm, reset_index=True)

    @classmethod
    def _build_test(cls, test_data, shuffle, seed):
        if not cls.train_called:
            raise RuntimeError(
                "Must first build trainset before building evalset or testset"
            )
        cls._check_col_names(test_data, is_train=False)
        if shuffle:
            test_data = cls.shuffle_data(test_data, seed)
        user_indices, item_indices = get_id_indices(
            test_data,
            cls.user_unique_vals,
            cls.item_unique_vals,
            is_train=False,
            is_ordered=False,
        )
        labels = _get_labels(test_data)
        return TransformedEvalSet(user_indices, item_indices, labels)

    @classmethod
    def build_evalset(cls, eval_data, shuffle=False, seed=42):
        """Build transformed eval data from original data."""
        return cls._build_test(eval_data, shuffle, seed)

    @classmethod
    def build_testset(cls, test_data, shuffle=False, seed=42):
        """Build transformed test data from original data."""
        return cls._build_test(test_data, shuffle, seed)


def _get_labels(data):
    if "label" in column_names(data):
        return column(data, "label", np.float32)
    # test data without labels gets dummy zeros for shape consistency
    return np.zeros(n_rows(data), dtype=np.float32)


def interaction_rows(data):
    """(n, 3) rows of (user, item, label), as pandas' ``to_numpy`` of those
    columns gives them: one numeric dtype when all three are numeric, object
    otherwise (raw ids may be strings)."""
    cols = [column(data, c) for c in ("user", "item", "label")]
    if all(c.dtype.kind in "biuf" for c in cols):
        return np.stack(cols, axis=1).astype(np.result_type(*cols), copy=False)
    rows = np.empty((len(cols[0]), 3), dtype=object)
    for j, c in enumerate(cols):
        rows[:, j] = c
    return rows


class DatasetPure(_Dataset):
    """Dataset builder for pure collaborative-filtering data.

    Examples
    --------
    >>> from librecommender_tpu_torch.data import DatasetPure
    >>> train_data, data_info = DatasetPure.build_trainset(train)
    >>> eval_data = DatasetPure.build_evalset(evals)
    """

    @classmethod
    def build_trainset(cls, train_data, shuffle=False, seed=42):
        cls._check_col_names(train_data, is_train=True)
        cls.user_unique_vals = np.unique(column(train_data, "user"))
        cls.item_unique_vals = np.unique(column(train_data, "item"))
        if shuffle:
            train_data = cls.shuffle_data(train_data, seed)

        user_indices, item_indices = get_id_indices(
            train_data,
            cls.user_unique_vals,
            cls.item_unique_vals,
            is_train=True,
            is_ordered=True,
        )
        labels = _get_labels(train_data)
        trainset = TransformedSet(user_indices, item_indices, labels)
        user_consumed, item_consumed = interaction_consumed(user_indices, item_indices)
        data_info = DataInfo(
            interaction_data=interaction_rows(train_data),
            user_consumed=user_consumed,
            item_consumed=item_consumed,
            user_unique_vals=cls.user_unique_vals,
            item_unique_vals=cls.item_unique_vals,
            seed=seed,
        )
        cls.train_called = True
        return trainset, data_info


class DatasetFeat(_Dataset):
    """Builds datasets from data containing sparse/dense/multi-sparse features.

    Examples
    --------
    >>> from librecommender_tpu_torch.data import DatasetFeat
    >>> train_data, data_info = DatasetFeat.build_trainset(
    ...     train, user_col, item_col, sparse_col, dense_col)
    """

    sparse_unique_vals = None
    multi_sparse_unique_vals = None
    sparse_col = None
    multi_sparse_col = None
    dense_col = None

    @classmethod
    def _set_feature_col(cls, sparse_col, dense_col, multi_sparse_col):
        cls.sparse_col = sparse_col or None
        cls.dense_col = dense_col or None
        if multi_sparse_col:
            if not all(isinstance(field, list) for field in multi_sparse_col):
                cls.multi_sparse_col = [multi_sparse_col]
            else:
                cls.multi_sparse_col = multi_sparse_col
        else:
            cls.multi_sparse_col = None

    @classmethod
    def _check_feature_cols(cls, user_col, item_col):
        all_sparse = (
            merge_sparse_col(cls.sparse_col, cls.multi_sparse_col)
            if cls.multi_sparse_col is not None
            else cls.sparse_col
        )
        sparse_cols = all_sparse or []
        dense_cols = cls.dense_col or []
        user_cols = user_col or []
        item_cols = item_col or []
        if len(sparse_cols) + len(dense_cols) != len(user_cols) + len(item_cols):
            raise ValueError(
                "Please make sure length of columns match, i.e. "
                "`len(sparse_cols) + len(dense_cols) == len(user_cols) + len(item_cols)`, "
                f"got sparse columns: {sparse_cols}, dense columns: {dense_cols}, "
                f"user columns: {user_cols}, item columns: {item_cols}"
            )
        mismatch = np.setxor1d(sparse_cols + dense_cols, user_cols + item_cols)
        if len(mismatch) > 0:
            raise ValueError(
                f"Got inconsistent columns: {mismatch}, please check the column names"
            )

    @classmethod
    def build_trainset(
        cls,
        train_data,
        user_col=None,
        item_col=None,
        sparse_col=None,
        dense_col=None,
        multi_sparse_col=None,
        unique_feat=False,
        pad_val="missing",
        shuffle=False,
        seed=42,
    ):
        cls._check_col_names(train_data, is_train=True)
        cls._set_feature_col(sparse_col, dense_col, multi_sparse_col)
        cls._check_feature_cols(user_col, item_col)
        cls.user_unique_vals = np.unique(column(train_data, "user"))
        cls.item_unique_vals = np.unique(column(train_data, "item"))
        cls.sparse_unique_vals = _sparse_unique_vals(cls.sparse_col, train_data)
        cls.multi_sparse_unique_vals, pad_val_dict = _multi_sparse_unique_vals(
            cls.multi_sparse_col, train_data, pad_val
        )
        if shuffle:
            train_data = cls.shuffle_data(train_data, seed)

        user_indices, item_indices = get_id_indices(
            train_data, cls.user_unique_vals, cls.item_unique_vals, True, True
        )
        labels = _get_labels(train_data)
        sparse_indices, dense_values = _build_feature_matrices(
            train_data,
            cls.sparse_col,
            cls.multi_sparse_col,
            cls.dense_col,
            cls.sparse_unique_vals,
            cls.multi_sparse_unique_vals,
            is_train=True,
            is_ordered=True,
        )
        trainset = TransformedSet(
            user_indices, item_indices, labels, sparse_indices, dense_values
        )

        all_sparse_col = (
            merge_sparse_col(cls.sparse_col, cls.multi_sparse_col)
            if cls.multi_sparse_col
            else sparse_col
        )
        col_name_mapping = col_name2index(user_col, item_col, all_sparse_col, cls.dense_col)
        (
            user_sparse_unique,
            user_dense_unique,
            item_sparse_unique,
            item_dense_unique,
        ) = construct_unique_feat(
            user_indices,
            item_indices,
            sparse_indices,
            dense_values,
            col_name_mapping,
            unique_feat,
        )
        sparse_offset = merge_offset(
            cls.sparse_col,
            cls.multi_sparse_col,
            cls.sparse_unique_vals,
            cls.multi_sparse_unique_vals,
        )
        sparse_oov = get_oov_pos(
            cls.sparse_col,
            cls.multi_sparse_col,
            cls.sparse_unique_vals,
            cls.multi_sparse_unique_vals,
        )
        multi_sparse_info = get_multi_sparse_info(
            all_sparse_col,
            cls.sparse_col,
            cls.multi_sparse_col,
            cls.sparse_unique_vals,
            cls.multi_sparse_unique_vals,
            pad_val_dict,
        )
        if cls.multi_sparse_col:
            col_name_mapping["multi_sparse"] = multi_sparse_col_map(multi_sparse_col)

        user_consumed, item_consumed = interaction_consumed(user_indices, item_indices)
        data_info = DataInfo(
            col_name_mapping,
            interaction_rows(train_data),
            user_sparse_unique,
            user_dense_unique,
            item_sparse_unique,
            item_dense_unique,
            user_consumed,
            item_consumed,
            cls.user_unique_vals,
            cls.item_unique_vals,
            cls.sparse_unique_vals,
            sparse_offset,
            sparse_oov,
            cls.multi_sparse_unique_vals,
            multi_sparse_info,
            seed,
        )
        cls.train_called = True
        return trainset, data_info


def _sparse_unique_vals(sparse_col, train_data):
    if not sparse_col:
        return None
    return {col: np.unique(column(train_data, col)) for col in sparse_col}


def _multi_sparse_unique_vals(multi_sparse_col, train_data, pad_val):
    if not multi_sparse_col:
        return None, None
    if not isinstance(pad_val, (list, tuple)):
        pad_val = [pad_val] * len(multi_sparse_col)
    if len(multi_sparse_col) != len(pad_val):
        raise ValueError("Length of `multi_sparse_col` and `pad_val` doesn't match")
    unique_vals, pad_val_dict = {}, {}
    for i, field in enumerate(multi_sparse_col):
        vals = set()
        for col in field:
            vals.update(column(train_data, col).tolist())
        vals.discard(pad_val[i])
        unique_vals[field[0]] = np.sort(list(vals))
        pad_val_dict[field[0]] = pad_val[i]
    return unique_vals, pad_val_dict


def _build_feature_matrices(
    data,
    sparse_cols,
    multi_sparse_cols,
    dense_cols,
    sparse_unique,
    multi_sparse_unique,
    is_train,
    is_ordered,
):
    sparse_indices, dense_values = None, None
    if sparse_cols or multi_sparse_cols:
        sparse_indices = merge_sparse_indices(
            data,
            sparse_cols,
            multi_sparse_cols,
            sparse_unique,
            multi_sparse_unique,
            is_train,
            is_ordered,
        )
    if dense_cols:
        dense_values = np.stack(
            [column(data, col, np.float32) for col in dense_cols], axis=1
        )
    return sparse_indices, dense_values
