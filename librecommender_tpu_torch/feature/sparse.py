"""Raw ids to ordinal indices.

Counterpart of ``column_sparse_indices`` and ``get_id_indices`` in
``librecommender_tpu/feature/sparse.py``, without pandas: object (string)
ids map through a dict where the JAX package uses pandas' categorical codes,
with the same result.
"""
import numpy as np

from ..data.columns import column


def _searchsorted_indices(values, unique):
    """Ordinal indices of ``values`` in sorted ``unique``; invalid -> len(unique)."""
    oov = len(unique)
    idx = np.searchsorted(unique, values)
    idx_clipped = np.minimum(idx, oov - 1)
    valid = unique[idx_clipped] == values
    return np.where(valid & (idx < oov), idx, oov).astype(np.int64)


def _mapped_indices(values, unique):
    """Hash coding for object columns; invalid -> len(unique)."""
    mapping = {v: i for i, v in enumerate(unique)}
    oov = len(unique)
    return np.fromiter((mapping.get(v, oov) for v in values), np.int64,
                       count=len(values))


def column_sparse_indices(values, unique, is_train, is_ordered):
    """Map raw feature values to ordinal indices w.r.t. ``unique`` values.

    OOV values (possible on eval/test data) map to ``len(unique)``.
    """
    values = np.asarray(values)
    if is_ordered:
        unique = np.asarray(unique)
        if (values.dtype == object or unique.dtype == object) and len(unique) > 64:
            # binary search over object arrays compares in Python; one hash
            # pass is faster once the vocabulary is not tiny
            return _mapped_indices(values, unique)
        if is_train:
            # all values are guaranteed to be in `unique`
            return np.searchsorted(unique, values)
        return _searchsorted_indices(values, unique)
    # unsorted vocab (retrain path appends new values at the end)
    mapping = {v: i for i, v in enumerate(unique)}
    oov = len(unique)
    if is_train:
        return np.array([mapping[v] for v in values])
    return np.array([mapping.get(v, oov) for v in values])


def get_id_indices(data, user_unique_vals, item_unique_vals, is_train, is_ordered):
    user_indices = column_sparse_indices(
        column(data, "user"), user_unique_vals, is_train, is_ordered
    )
    item_indices = column_sparse_indices(
        column(data, "item"), item_unique_vals, is_train, is_ordered
    )
    return user_indices, item_indices
