"""Write new feature values into DataInfo's unique feature tables.

Counterpart of the part of ``librecommender_tpu/feature/update.py`` that
``DataInfo.assign_user_features`` / ``assign_item_features`` run. Data is a
column mapping (a dict of 1-D arrays, or a DataFrame where pandas exists);
the functions that merge a new training set into an old DataInfo come with
retraining.
"""
import numpy as np

from ..data.columns import column, column_names
from .sparse import column_sparse_indices


def get_row_id_masks(data_ids, unique_ids):
    """(row of each id in ``unique_ids``, -1 where unknown; whether known)."""
    data_ids = np.asarray(data_ids)
    id_mask = np.isin(data_ids, unique_ids)
    mapping = {v: i for i, v in enumerate(unique_ids)}
    row_idxs = np.array([mapping.get(i, -1) for i in data_ids])
    return row_idxs, id_mask


def update_new_sparse_feats(
    data,
    row_idxs,
    id_mask,
    unique_matrix,
    sparse_unique_vals,
    multi_sparse_unique_vals,
    col_info,
    col_mapping,
    sparse_offset,
):
    """Set the sparse indices of known ids' rows to their new values; a
    column missing from ``data``, an unknown id and a value outside the
    column's vocabulary leave the stored index as it is."""
    if unique_matrix is None:
        return None
    names = column_names(data)
    for feat_idx, (col, col_index) in enumerate(zip(col_info.name, col_info.index)):
        if col not in names:
            continue
        if "multi_sparse" in col_mapping and col in col_mapping["multi_sparse"]:
            unique_vals = multi_sparse_unique_vals[col_mapping["multi_sparse"][col]]
        elif multi_sparse_unique_vals and col in multi_sparse_unique_vals:
            unique_vals = multi_sparse_unique_vals[col]
        else:
            unique_vals = sparse_unique_vals[col]
        col_values = column(data, col)
        col_mask = id_mask & np.isin(col_values, unique_vals)
        rows, values = row_idxs[col_mask], col_values[col_mask]
        indices = column_sparse_indices(values, unique_vals, is_train=True,
                                        is_ordered=False)
        unique_matrix[rows, feat_idx] = sparse_offset[col_index] + indices
    return unique_matrix


def update_new_dense_feats(data, row_idxs, id_mask, unique_matrix, col_info):
    """Set the dense values of known ids' rows to their new values."""
    if unique_matrix is None:
        return None
    names = column_names(data)
    for feat_idx, col in enumerate(col_info.name):
        if col in names:
            unique_matrix[row_idxs[id_mask], feat_idx] = column(
                data, col, np.float32)[id_mask]
    return unique_matrix
