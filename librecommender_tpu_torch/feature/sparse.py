"""Sparse feature encoding: ordinal per-column indices in one flat index space.

Counterpart of ``librecommender_tpu/feature/sparse.py``, without pandas:
object (string) values map through a dict where the JAX package uses pandas'
categorical codes, with the same result. The layout is the JAX package's:

- every sparse column gets ``len(unique) + 1`` consecutive rows in one flat
  embedding index space; the extra row is the column's OOV slot, placed last.
- plain sparse columns come first, multi-sparse fields after them; columns
  belonging to the same multi-sparse field share one vocabulary + OOV slot.
- ``offset[j]`` is the start of column ``j``'s block, ``oov[j]`` its OOV index.
"""
import itertools

import numpy as np

from ..data.columns import column, n_rows
from .multi_sparse import (
    get_multi_sparse_indices_matrix,
    get_multi_sparse_offset,
    multi_sparse_oov,
)


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


def column_sparse_indices(values, unique, is_train, is_ordered, multi_sparse=False):
    """Map raw feature values to ordinal indices w.r.t. ``unique`` values.

    OOV values (possible on eval/test data, or padding in multi-sparse columns)
    map to ``len(unique)``.
    """
    values = np.asarray(values)
    if is_ordered:
        unique = np.asarray(unique)
        if (values.dtype == object or unique.dtype == object) and len(unique) > 64:
            # binary search over object arrays compares in Python; one hash
            # pass is faster once the vocabulary is not tiny
            return _mapped_indices(values, unique)
        if is_train and not multi_sparse:
            # all values are guaranteed to be in `unique`
            return np.searchsorted(unique, values)
        return _searchsorted_indices(values, unique)
    # unsorted vocab (retrain path appends new values at the end)
    mapping = {v: i for i, v in enumerate(unique)}
    oov = len(unique)
    if is_train and not multi_sparse:
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


def merge_sparse_col(sparse_col, multi_sparse_col):
    """All sparse column names with multi-sparse sub-columns flattened after."""
    flat = list(itertools.chain.from_iterable(multi_sparse_col))
    return sparse_col + flat if sparse_col else flat


def get_sparse_offset(sparse_col, sparse_unique):
    sizes = [len(sparse_unique[col]) + 1 for col in sparse_col]
    return np.cumsum([0, *sizes])[:-1]


def get_last_offset(sparse_col, sparse_unique):
    """End of the plain-sparse region = start of the multi-sparse region."""
    return np.sum([len(sparse_unique[col]) + 1 for col in sparse_col])


def merge_offset(sparse_col, multi_sparse_col, sparse_unique, multi_sparse_unique):
    if not sparse_col and not multi_sparse_col:
        return None
    parts = []
    if sparse_col:
        parts.append(get_sparse_offset(sparse_col, sparse_unique))
    if multi_sparse_col:
        ms_offset = get_multi_sparse_offset(multi_sparse_col, multi_sparse_unique)
        if sparse_col:
            ms_offset = ms_offset + get_last_offset(sparse_col, sparse_unique)
        parts.append(ms_offset)
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


def sparse_oov(sparse_col, sparse_unique):
    sizes = [len(sparse_unique[col]) + 1 for col in sparse_col]
    return np.cumsum(sizes) - 1


def get_oov_pos(sparse_col, multi_sparse_col, sparse_unique, multi_sparse_unique):
    if not sparse_col and not multi_sparse_col:
        return None
    parts = []
    if sparse_col:
        parts.append(sparse_oov(sparse_col, sparse_unique))
    if multi_sparse_col:
        ms = multi_sparse_oov(multi_sparse_col, multi_sparse_unique)
        if sparse_col:
            ms = ms + get_last_offset(sparse_col, sparse_unique)
        parts.append(ms)
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


def get_sparse_indices_matrix(data, sparse_col, sparse_unique, is_train, is_ordered):
    sparse_indices = np.zeros((n_rows(data), len(sparse_col)), dtype=np.int32)
    for i, col in enumerate(sparse_col):
        sparse_indices[:, i] = column_sparse_indices(
            column(data, col), sparse_unique[col], is_train, is_ordered
        )
    return sparse_indices


def merge_sparse_indices(
    data,
    sparse_col,
    multi_sparse_col,
    sparse_unique,
    multi_sparse_unique,
    is_train,
    is_ordered,
):
    """Per-sample sparse index matrix over the flat index space.

    Plain sparse columns first, multi-sparse sub-columns after, each shifted by
    its column offset so the result indexes directly into the flat embedding.
    """
    sp, ms = None, None
    if sparse_col:
        sp = get_sparse_indices_matrix(
            data, sparse_col, sparse_unique, is_train, is_ordered
        )
        sp = sp + get_sparse_offset(sparse_col, sparse_unique)
    if multi_sparse_col:
        ms = get_multi_sparse_indices_matrix(
            data, multi_sparse_col, multi_sparse_unique, is_train, is_ordered
        )
        ms = ms + get_multi_sparse_offset(multi_sparse_col, multi_sparse_unique)
        if sparse_col:
            ms = ms + get_last_offset(sparse_col, sparse_unique)
    if sp is not None and ms is not None:
        return np.concatenate([sp, ms], axis=1)
    return sp if sp is not None else ms
