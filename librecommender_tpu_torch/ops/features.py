"""Device-resident unique feature tables + per-sample assembly.

Counterpart of ``FeatureTables`` in ``librecommender_tpu/ops/features.py``:
the per-user / per-item unique feature rows (DataInfo's
``user_sparse_unique`` etc., incl. trailing OOV row) are moved to the model's
device once at model-build time; every train/predict/recommend step gathers
them there from the (user, item) id tensors, so the hot loop moves only ids.
``rows_from_dataframe`` assembles the full feature rows of a batch of
(user, item) rows whose features come with the data (``prediction/``).
"""
import numpy as np
import torch

from ..data.columns import column, column_names
from ..utils.validate import sparse_feat_size


class FeatureTables:
    """Static feature layout + device tensors for one DataInfo."""

    def __init__(self, data_info, device):
        self.data_info = data_info
        # snapshot of DataInfo.feature_version: a feature update bumps it,
        # signalling models to rebuild these tables
        self.version = getattr(data_info, "feature_version", 0)
        self.n_sparse_fields = len(data_info.sparse_col.name)
        self.n_dense_fields = len(data_info.dense_col.name)
        self.sparse_vocab = sparse_feat_size(data_info)
        self.multi_sparse_info = data_info.multi_sparse_combine_info

        # static column layout: position lists into the full field order
        self.user_sparse_pos = list(data_info.user_sparse_col.index)
        self.item_sparse_pos = list(data_info.item_sparse_col.index)
        self.user_dense_pos = list(data_info.user_dense_col.index)
        self.item_dense_pos = list(data_info.item_dense_col.index)

        def _dev(arr, dtype):
            if arr is None:
                return None
            return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(device)

        # int64: the dtype torch indexes with
        self.user_sparse = _dev(data_info.user_sparse_unique, np.int64)
        self.item_sparse = _dev(data_info.item_sparse_unique, np.int64)
        self.user_dense = _dev(data_info.user_dense_unique, np.float32)
        self.item_dense = _dev(data_info.item_dense_unique, np.float32)

    @property
    def has_sparse(self):
        return self.n_sparse_fields > 0

    @property
    def has_dense(self):
        return self.n_dense_fields > 0

    def _rows_for(self, n_fields, user_table, item_table, user_pos, item_pos,
                  users, items, user_rows, item_rows):
        cols = [None] * n_fields
        if user_table is not None or user_rows is not None:
            rows = user_rows if user_rows is not None else user_table[users.long()]
            for j, pos in enumerate(user_pos):
                cols[pos] = rows[:, j]
        if item_table is not None or item_rows is not None:
            rows = item_rows if item_rows is not None else item_table[items.long()]
            for j, pos in enumerate(item_pos):
                cols[pos] = rows[:, j]
        return torch.stack(cols, dim=1)

    def sparse_for(self, users, items, user_rows=None, item_rows=None):
        """(B,) user ids + (B,) item ids -> (B, F) sparse indices in full
        field order, or None. ``user_rows``/``item_rows`` override the table
        gather with explicit (B, F_u)/(B, F_i) rows (request-time temporary
        features)."""
        if not self.has_sparse:
            return None
        return self._rows_for(
            self.n_sparse_fields, self.user_sparse, self.item_sparse,
            self.user_sparse_pos, self.item_sparse_pos, users, items,
            user_rows, item_rows)

    def dense_for(self, users, items, user_rows=None, item_rows=None):
        if not self.has_dense:
            return None
        return self._rows_for(
            self.n_dense_fields, self.user_dense, self.item_dense,
            self.user_dense_pos, self.item_dense_pos, users, items,
            user_rows, item_rows)

    def build_user_sparse_row(self, uid, user_feats):
        """Host-side: the stored user sparse row with named overrides
        applied; values map through sparse_idx_mapping + offsets, unknown
        values fall to the column OOV."""
        data_info = self.data_info
        row = np.array(np.asarray(data_info.user_sparse_unique)[uid])
        name_to_j = {
            name: j for j, name in enumerate(data_info.user_sparse_col.name)
        }
        for name, value in (user_feats or {}).items():
            if name not in name_to_j:
                continue
            j = name_to_j[name]
            col_pos = data_info.user_sparse_col.index[j]
            mapping = (data_info.sparse_idx_mapping or {}).get(name, {})
            if value in mapping:
                row[j] = data_info.sparse_offset[col_pos] + mapping[value]
            else:
                row[j] = data_info.sparse_oov[col_pos]
        return row

    def build_user_dense_row(self, uid, user_feats):
        data_info = self.data_info
        row = np.array(np.asarray(data_info.user_dense_unique)[uid])
        name_to_j = {
            name: j for j, name in enumerate(data_info.user_dense_col.name)
        }
        for name, value in (user_feats or {}).items():
            if name in name_to_j:
                row[name_to_j[name]] = float(value)
        return row


def rows_from_dataframe(data_info, data):
    """The feature rows of a column mapping (a dict of 1-D arrays, or a
    DataFrame), in full field order: ``(sparse_rows (B, F_sp) int64 or None,
    dense_rows (B, F_d) float32 or None)``.

    Every sparse and dense column of ``data_info`` must be in ``data``
    (``ValueError`` otherwise). Sparse values map through
    ``sparse_idx_mapping`` plus the column's offset; unknown values go to
    the column's OOV index."""
    names = column_names(data)
    for col in list(data_info.sparse_col.name) + list(data_info.dense_col.name):
        if col not in names:
            raise ValueError(f"Column `{col}` doesn't exist in data")
    sparse_rows, dense_rows = None, None
    sparse_cols = list(data_info.sparse_col.name)
    if sparse_cols:
        multi_map = (data_info.col_name_mapping or {}).get("multi_sparse", {})
        sparse_rows = np.empty((len(column(data, sparse_cols[0])), len(sparse_cols)),
                               np.int64)
        for field_idx, col in enumerate(sparse_cols):
            mapping = (data_info.sparse_idx_mapping or {}).get(
                multi_map.get(col, col), {})
            ordinal = np.array([mapping.get(v, -1) for v in column(data, col)],
                               np.int64)
            sparse_rows[:, field_idx] = np.where(
                ordinal < 0, data_info.sparse_oov[field_idx],
                ordinal + data_info.sparse_offset[field_idx])
    dense_cols = list(data_info.dense_col.name)
    if dense_cols:
        dense_rows = np.stack([column(data, c, np.float32) for c in dense_cols],
                              axis=1)
    return sparse_rows, dense_rows
