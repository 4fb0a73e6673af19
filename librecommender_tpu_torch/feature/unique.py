"""Build canonical per-user / per-item feature rows from interaction data.

Counterpart of ``librecommender_tpu/feature/unique.py``: for every user
(item) one row of its sparse indices / dense values is kept, taking the LAST
occurrence in the data.
"""
import numpy as np


def construct_unique_feat(
    user_indices,
    item_indices,
    sparse_indices,
    dense_values,
    col_name_mapping,
    unique_feat,
):
    # stable sort preserves occurrence order so "last occurrence wins"
    sort_kind = "quicksort" if unique_feat else "mergesort"
    user_pos = np.argsort(user_indices, kind=sort_kind)
    item_pos = np.argsort(item_indices, kind=sort_kind)

    def _unique_rows(matrix, family, indices, pos):
        if family not in col_name_mapping:
            return None
        cols = list(col_name_mapping[family].values())
        return _compress_unique_values(matrix, cols, indices, pos)

    user_sparse = _unique_rows(sparse_indices, "user_sparse_col", user_indices, user_pos)
    item_sparse = _unique_rows(sparse_indices, "item_sparse_col", item_indices, item_pos)
    user_dense = _unique_rows(dense_values, "user_dense_col", user_indices, user_pos)
    item_dense = _unique_rows(dense_values, "item_dense_col", item_indices, item_pos)
    return user_sparse, user_dense, item_sparse, item_dense


def _compress_unique_values(orig_val, col, indices, pos):
    """One row per unique index, keeping the last row seen for each."""
    values = np.take(orig_val, col, axis=1)
    values = values.reshape(-1, 1) if orig_val.ndim == 1 else values
    sorted_indices = indices[pos]
    last_mask = np.empty(len(sorted_indices), dtype=bool)
    last_mask[:-1] = sorted_indices[:-1] != sorted_indices[1:]
    last_mask[-1] = True
    rows = pos[last_mask]
    unique_values = values[rows]
    return unique_values
