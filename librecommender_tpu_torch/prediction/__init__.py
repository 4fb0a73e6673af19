"""Batched prediction with the features given in the data.

Counterpart of ``librecommender_tpu/prediction/__init__.py``
(``predict_data_with_feats``): every (user, item) row of a column mapping is
scored with the sparse and dense features of that row rather than the
stored unique tables. Sequences still come from each user's stored recent
history, and SIM scores through its second stage, as its inference does.
"""
import numpy as np
import torch

from ..data.columns import column
from ..ops.features import rows_from_dataframe

__all__ = ["predict_data_with_feats"]


@torch.no_grad()
def predict_data_with_feats(model, data, batch_size=None, cold_start="average",
                            inner_id=False):
    """Score every row of ``data``: a column mapping (a dict of 1-D arrays,
    or a DataFrame) with ``user`` and ``item`` and every sparse and dense
    feature column of the model; a missing column raises ``ValueError``.
    Unknown users and items score through the OOV rows."""
    if cold_start not in ("average", "popular"):
        raise ValueError(f"Unknown cold start strategy: {cold_start}")
    model._sync_feature_tables()
    users, items = model.convert_ids(column(data, "user"), column(data, "item"),
                                     inner_id)
    sparse_rows, dense_rows = rows_from_dataframe(model.data_info, data)
    n = len(users)
    batch_size = batch_size or n
    params = model._tree()
    preds = np.zeros(n, dtype=np.float32)
    for start in range(0, n, batch_size):
        rows = slice(start, start + batch_size)
        inputs = {"user": model._to_device(users[rows]),
                  "item": model._to_device(items[rows])}
        if sparse_rows is not None:
            inputs["sparse_row_full"] = model._to_device(sparse_rows[rows])
        if dense_rows is not None:
            inputs["dense_row_full"] = model._to_device(dense_rows[rows])
        preds[rows] = model._forward(params, inputs, train=False).cpu().numpy()
    return model._sigmoid_or_clip(preds)
