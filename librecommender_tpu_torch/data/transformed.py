"""Transformed datasets: inner-id index arrays ready for training and eval.

Counterpart of ``librecommender_tpu/data/transformed.py``, without pandas.
"""
import numpy as np
from scipy.sparse import csr_matrix

from .consumed import grouped_in_first_appearance, interaction_consumed
from ..sampling.negatives import negatives_from_unconsumed


class TransformedSet:
    """Training data after transformation to inner ids.

    Parameters
    ----------
    user_indices, item_indices : numpy.ndarray
        Inner-id rows.
    labels : numpy.ndarray
    sparse_indices : numpy.ndarray or None
        Per-sample sparse feature indices in the flat index space.
    dense_values : numpy.ndarray or None
    """

    def __init__(self, user_indices=None, item_indices=None, labels=None,
                 sparse_indices=None, dense_values=None):
        self._user_indices = user_indices
        self._item_indices = item_indices
        self._labels = labels
        self._sparse_indices = sparse_indices
        self._dense_values = dense_values
        self._sparse_interaction = self._build_sparse_interaction()

    def _build_sparse_interaction(self):
        """CSR of the labels; of duplicate (user, item) rows the last one
        counts, as with pandas' ``drop_duplicates(keep="last")``."""
        users = np.asarray(self.user_indices, np.int64)
        items = np.asarray(self.item_indices, np.int64)
        labels = np.asarray(self.labels)
        pair = users * (int(items.max(initial=0)) + 1) + items
        n = len(pair)
        _, rev_first = np.unique(pair[::-1], return_index=True)
        last = np.sort(n - 1 - rev_first)
        return csr_matrix((labels[last], (users[last], items[last])),
                          dtype=np.float32)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, index):
        return self.user_indices[index], self.item_indices[index], self.labels[index]

    @property
    def user_indices(self):
        return self._user_indices

    @property
    def item_indices(self):
        return self._item_indices

    @property
    def sparse_indices(self):
        return self._sparse_indices

    @property
    def dense_values(self):
        return self._dense_values

    @property
    def labels(self):
        return self._labels

    @property
    def sparse_interaction(self):
        """User-item interactions as :class:`scipy.sparse.csr_matrix`."""
        return self._sparse_interaction


class TransformedEvalSet:
    """Eval/test data; supports one-shot negative sampling for ranking eval."""

    def __init__(self, user_indices, item_indices, labels):
        self.user_indices = np.asarray(user_indices)
        self.item_indices = np.asarray(item_indices)
        self.labels = np.asarray(labels)
        self.has_sampled = False
        self.positive_consumed = self._get_positive_consumed()

    def _get_positive_consumed(self):
        """``{user: sorted distinct positive items}``, users in the order of
        their first positive row (``evaluate.sample_users`` draws from this
        order)."""
        labels = np.asarray(self.labels)
        # data without a label column carries dummy zeros -> treat all as positive
        positive = np.ones(len(labels), bool) if np.all(labels == 0) else labels != 0
        grouped = grouped_in_first_appearance(
            self.user_indices, self.item_indices, positive)
        return {u: np.unique(items).tolist() for u, items in grouped.items()}

    def build_negatives(self, n_items, num_neg, seed):
        """Expand each positive into (1 + num_neg) rows with 0/1 labels."""
        self.has_sampled = True
        user_consumed, _ = interaction_consumed(self.user_indices, self.item_indices)
        consumed_set = {u: set(items) for u, items in user_consumed.items()}
        items_neg = negatives_from_unconsumed(
            consumed_set,
            self.user_indices,
            self.item_indices,
            n_items,
            num_neg,
            seed=seed,
        )
        total = num_neg + 1
        self.user_indices = np.repeat(self.user_indices, total)
        pos_items = np.repeat(self.item_indices, total)
        items = pos_items.copy()
        items_neg = items_neg.reshape(-1, num_neg)
        for k in range(num_neg):
            items[k + 1 :: total] = items_neg[:, k]
        self.item_indices = items
        self.labels = np.zeros_like(items, dtype=np.float32)
        self.labels[::total] = 1.0

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, index):
        return self.user_indices[index], self.item_indices[index], self.labels[index]
