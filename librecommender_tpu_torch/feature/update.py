"""Retrain-time feature bookkeeping: vocabulary extension, offset and OOV
adjustment, and new user/item feature rows.

Counterpart of ``librecommender_tpu/feature/update.py``: what
``merge_trainset`` runs to carry an old DataInfo's vocabularies and unique
feature tables over to the merged data, and what
``DataInfo.assign_user_features`` / ``assign_item_features`` run. Data is a
column mapping (a dict of 1-D arrays, or a DataFrame where pandas exists).
"""
import numpy as np

from ..data.columns import column, column_names, last_rows
from .sparse import column_sparse_indices


def update_unique_vals(data, old_unique_vals, pad_val=None):
    """Append values not yet in the vocabulary; existing order is preserved."""
    diff = np.setdiff1d(data, old_unique_vals)
    if pad_val is not None:
        diff = diff[diff != pad_val]
    return np.append(old_unique_vals, diff) if len(diff) > 0 else old_unique_vals


def update_id_unique(data, data_info):
    user_unique = update_unique_vals(np.unique(column(data, "user")),
                                     data_info.user_unique_vals)
    item_unique = update_unique_vals(np.unique(column(data, "item")),
                                     data_info.item_unique_vals)
    return user_unique, item_unique


def update_sparse_unique(data, data_info):
    if not data_info.sparse_unique_vals:
        return None
    old = data_info.sparse_unique_vals
    names = column_names(data)
    result = {}
    for col in data_info.sparse_col.name:
        if col not in names:
            raise ValueError(f"Old column `{col}` doesn't exist in new data")
        if col in old:
            result[col] = update_unique_vals(np.unique(column(data, col)), old[col])
    return result


def update_multi_sparse_unique(data, data_info):
    if not data_info.multi_sparse_unique_vals:
        return None
    old = data_info.multi_sparse_unique_vals
    sub_to_main = data_info.col_name_mapping["multi_sparse"]
    names = column_names(data)
    field_values = {}
    for col in data_info.sparse_col.name:
        if col not in names:
            raise ValueError(f"Old column `{col}` doesn't exist in new data")
        main = col if col in old else sub_to_main.get(col)
        if main is not None:
            field_values.setdefault(main, []).extend(np.unique(column(data, col)))
    pad_val = data_info.multi_sparse_combine_info.pad_val
    return {
        main: update_unique_vals(vals, old[main], pad_val[main])
        for main, vals in field_values.items()
    }


def update_unique_feats(
    data,
    data_info,
    unique_ids,
    sparse_unique,
    multi_sparse_unique,
    sparse_offset,
    sparse_oov,
    is_user,
):
    """Re-layout old unique feature rows to the new offsets and fill rows for
    new ids with the (new) OOV indices, then overwrite with features seen in
    the new data (last occurrence wins)."""
    col = "user" if is_user else "item"
    data = last_rows(data, col)
    new_num = len(unique_ids)
    sp_col_info = data_info.user_sparse_col if is_user else data_info.item_sparse_col
    ds_col_info = data_info.user_dense_col if is_user else data_info.item_dense_col
    sparse_feats = get_sparse_feats(
        data_info, sparse_offset, sparse_oov, new_num, sp_col_info.index, is_user
    )
    dense_feats = get_dense_feats(data_info, new_num, is_user)
    row_idx, id_mask = get_row_id_masks(column(data, col), unique_ids)
    sparse_feats = update_new_sparse_feats(
        data,
        row_idx,
        id_mask,
        sparse_feats,
        sparse_unique,
        multi_sparse_unique,
        sp_col_info,
        data_info.col_name_mapping,
        sparse_offset,
    )
    dense_feats = update_new_dense_feats(data, row_idx, id_mask, dense_feats, ds_col_info)
    return sparse_feats, dense_feats


def get_sparse_feats(data_info, sparse_offset, sparse_oov, new_num, col_idxs, is_user):
    old_sp = data_info.user_sparse_unique if is_user else data_info.item_sparse_unique
    if old_sp is None:
        return None
    old_sp = old_sp[:-1]  # drop the trailing OOV row
    new_sp = adjust_offsets(data_info, old_sp, sparse_offset, col_idxs)
    new_sp = update_oovs(data_info, old_sp, new_sp, sparse_oov, col_idxs)
    assert new_num >= len(old_sp)
    if new_num > len(old_sp):
        oovs = sparse_oov[col_idxs]
        filler = np.full([new_num - len(old_sp), old_sp.shape[1]], oovs, old_sp.dtype)
        new_sp = np.vstack([new_sp, filler])
    return new_sp


def get_dense_feats(data_info, new_num, is_user):
    old_ds = data_info.user_dense_unique if is_user else data_info.item_dense_unique
    if old_ds is None:
        return None
    new_ds = old_ds[:-1]
    if new_num > len(new_ds):
        filler = np.zeros([new_num - len(new_ds), old_ds.shape[1]], old_ds.dtype)
        new_ds = np.vstack([new_ds, filler])
    return new_ds


def adjust_offsets(data_info, old_sparse, sparse_offset, col_idxs):
    """Shift stored indices by how much each column's block start moved."""
    diff = sparse_offset[col_idxs] - data_info.sparse_offset[col_idxs]
    return old_sparse + diff


def update_oovs(data_info, old_sparse, new_sparse, sparse_oov, col_idxs):
    """Rows that pointed at the old OOV slot must point at the new one."""
    old_oov = data_info.sparse_oov
    for i, col in enumerate(col_idxs):
        mask = old_sparse[:, i] == old_oov[col]
        new_sparse[mask, i] = sparse_oov[col]
    return new_sparse


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
