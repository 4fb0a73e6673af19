"""Multi-sparse (multi-valued) feature fields.

Counterpart of ``librecommender_tpu/feature/multi_sparse.py`` over column
mappings. A field groups several columns that share one vocabulary + OOV
slot, e.g. ("genre1", "genre2", "genre3"). The first column's name
represents the field.
"""
import itertools

import numpy as np

from ..data.columns import column, n_rows


def get_multi_sparse_indices_matrix(
    data, multi_sparse_col, multi_sparse_unique, is_train, is_ordered
):
    from .sparse import column_sparse_indices

    cols = list(itertools.chain.from_iterable(multi_sparse_col))
    indices = np.zeros((n_rows(data), len(cols)), dtype=np.int32)
    i = 0
    for field in multi_sparse_col:
        unique_vals = multi_sparse_unique[field[0]]
        for col in field:
            indices[:, i] = column_sparse_indices(
                column(data, col),
                unique_vals,
                is_train,
                is_ordered,
                multi_sparse=True,
            )
            i += 1
    return indices


def get_multi_sparse_offset(multi_sparse_col, multi_sparse_unique):
    sizes = [len(multi_sparse_unique[f[0]]) + 1 for f in multi_sparse_col]
    field_offset = np.cumsum([0, *sizes])[:-1]
    # every sub-column of a field shares the field's offset
    offset = [
        field_offset[i] for i, field in enumerate(multi_sparse_col) for _ in field
    ]
    return np.array(offset)


def multi_sparse_oov(multi_sparse_col, multi_sparse_unique, extend=True):
    sizes = [len(multi_sparse_unique[f[0]]) + 1 for f in multi_sparse_col]
    field_oov = np.cumsum(sizes) - 1
    if not extend:
        return field_oov
    oov = [field_oov[i] for i, field in enumerate(multi_sparse_col) for _ in field]
    return np.array(oov)


def get_multi_sparse_info(
    all_sparse_cols,
    sparse_col,
    multi_sparse_col,
    sparse_unique,
    multi_sparse_unique,
    pad_val,
):
    from ..data.data_info import MultiSparseInfo
    from .sparse import get_last_offset

    if not multi_sparse_col:
        return None
    field_offset = [all_sparse_cols.index(f[0]) for f in multi_sparse_col]
    field_len = [len(f) for f in multi_sparse_col]
    feat_oov = multi_sparse_oov(multi_sparse_col, multi_sparse_unique, extend=False)
    if sparse_col:
        feat_oov = feat_oov + get_last_offset(sparse_col, sparse_unique)
    return MultiSparseInfo(field_offset, field_len, feat_oov, pad_val)


def multi_sparse_col_map(multi_sparse_col):
    """Map each non-representative sub-column to its field's first column."""
    mapping = {}
    for field in multi_sparse_col:
        for col in field[1:]:
            mapping[col] = field[0]
    return mapping


def recover_sparse_cols(data_info):
    """Recover (sparse_cols, nested multi_sparse_cols) from a DataInfo."""
    total = data_info.sparse_col.name
    sparse_cols, multi_sparse_cols = None, None
    if data_info.sparse_unique_vals:
        sparse_cols = [c for c in total if c in data_info.sparse_unique_vals]
    if data_info.multi_sparse_unique_vals:
        multi_sparse_cols = []
        i, field = 0, 0
        while i < len(total):
            if total[i] in data_info.multi_sparse_unique_vals:
                field_len = data_info.multi_sparse_combine_info.field_len[field]
                multi_sparse_cols.append(total[i : i + field_len])
                i += field_len
                field += 1
            else:
                i += 1
    return sparse_cols, multi_sparse_cols


def true_sparse_field_size(data_info, sparse_field_size, combiner):
    """Field count after multi-sparse combining collapses each field to one slot."""
    if data_info.multi_sparse_combine_info and combiner in ("sum", "mean", "sqrtn"):
        field_len = data_info.multi_sparse_combine_info.field_len
        return sparse_field_size - (sum(field_len) - len(field_len))
    return sparse_field_size
