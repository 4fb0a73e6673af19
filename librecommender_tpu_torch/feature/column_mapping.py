"""Column name to matrix index mapping.

Counterpart of ``librecommender_tpu/feature/column_mapping.py``. Format:
``{column_family: {column_name: index}}`` where index points into the
sample-level sparse-index / dense-value matrices.
"""
from collections import OrderedDict, defaultdict


def col_name2index(user_col=None, item_col=None, sparse_col=None, dense_col=None):
    mapping = defaultdict(OrderedDict)
    if sparse_col:
        mapping["sparse_col"].update({c: i for i, c in enumerate(sparse_col)})
    if dense_col:
        mapping["dense_col"].update({c: i for i, c in enumerate(dense_col)})

    def _assign(family, all_cols, owner_cols):
        # preserve the order of `all_cols` (the matrix column order)
        for col in all_cols:
            if col in owner_cols:
                mapping[family][col] = mapping[_family_of(all_cols)][col]

    def _family_of(cols):
        return "sparse_col" if cols is sparse_col else "dense_col"

    if user_col and sparse_col:
        _assign("user_sparse_col", sparse_col, set(user_col))
    if user_col and dense_col:
        _assign("user_dense_col", dense_col, set(user_col))
    if item_col and sparse_col:
        _assign("item_sparse_col", sparse_col, set(item_col))
    if item_col and dense_col:
        _assign("item_dense_col", dense_col, set(item_col))
    return dict(mapping)
