"""Dataset builders for pure collaborative-filtering data.

Counterpart of ``DatasetPure`` in ``librecommender_tpu/data/dataset.py``
(``build_trainset``, ``build_evalset``, ``build_testset``), without pandas:
the data is any column mapping (see ``columns.py``) whose first two columns
are ``user`` and ``item``. Class-level state carries the unique ids from the
train build to later eval/test builds, as in the JAX package.
"""
import numpy as np

from .columns import column, column_names, n_rows, take_rows
from .consumed import interaction_consumed
from .data_info import DataInfo
from .transformed import TransformedEvalSet, TransformedSet
from ..feature.sparse import get_id_indices


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
