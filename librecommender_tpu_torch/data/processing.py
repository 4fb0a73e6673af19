"""Raw-data preprocessing: dense normalization and multi-value splitting.

Counterpart of ``librecommender_tpu/data/processing.py``, on column mappings
(see ``columns.py``) instead of DataFrames. The JAX package normalizes with
scikit-learn's ``MinMaxScaler``, ``StandardScaler``, ``RobustScaler`` and
``PowerTransformer``; the port has numpy copies of the four (scikit-learn is
not a dependency of the port). ``PowerTransformer`` is Yeo-Johnson, its
lambda and transform from ``scipy.stats.yeojohnson`` (as scikit-learn
computes them), then standardized.
"""
import re

import numpy as np
from scipy import stats

from .columns import column, column_names, replace_where


def _handle_zeros_in_scale(scale, constant_mask=None):
    """Scales of (near) constant features set to 1, as scikit-learn does."""
    scale = np.array(scale, copy=True)
    if constant_mask is None:
        constant_mask = scale < 10 * np.finfo(scale.dtype).eps
    scale[constant_mask] = 1.0
    return scale


def _is_constant(var, mean, n):
    """Features whose variance (float64) is indistinguishable from a
    constant's, by the two-pass algorithm's error bound (scikit-learn's
    rule)."""
    eps = np.finfo(np.float64).eps
    return var <= n * eps * var + (n * mean * eps) ** 2


class _MinMax:
    def fit(self, X):
        data_min, data_max = np.nanmin(X, axis=0), np.nanmax(X, axis=0)
        self.scale_ = 1.0 / _handle_zeros_in_scale(data_max - data_min)
        self.min_ = 0.0 - data_min * self.scale_
        return self

    def transform(self, X):
        return X * self.scale_ + self.min_


class _Standard:
    def fit(self, X):
        # the corrected two-pass algorithm with float64 accumulators
        n = X.shape[0]
        total = np.sum(X, axis=0, dtype=np.float64)
        self.mean_ = total / n
        temp = X - self.mean_
        correction = np.sum(temp, axis=0, dtype=np.float64)
        self.var_ = (np.sum(temp**2, axis=0, dtype=np.float64)
                     - correction**2 / n) / n
        self.scale_ = _handle_zeros_in_scale(
            np.sqrt(self.var_), _is_constant(self.var_, self.mean_, n))
        return self

    def transform(self, X):
        return ((X - self.mean_) / self.scale_).astype(X.dtype)


class _Robust:
    def fit(self, X):
        self.center_ = np.nanmedian(X, axis=0)
        q = np.transpose([np.nanpercentile(X[:, j], (25.0, 75.0))
                          for j in range(X.shape[1])])
        self.scale_ = _handle_zeros_in_scale(q[1] - q[0])
        return self

    def transform(self, X):
        return (X - self.center_) / self.scale_


class _YeoJohnson:
    """Yeo-Johnson power transform, standardized after."""

    def fit(self, X):
        n = X.shape[0]
        mean = np.mean(X, axis=0, dtype=np.float64)
        var = np.var(X, axis=0, dtype=np.float64)
        self.lambdas_ = np.empty(X.shape[1], dtype=X.dtype)
        with np.errstate(invalid="ignore"):
            for j in range(X.shape[1]):
                # a constant feature keeps lambda 1, the identity
                if _is_constant(var[j], mean[j], n):
                    self.lambdas_[j] = 1.0
                    continue
                col = X[:, j]
                self.lambdas_[j] = stats.yeojohnson(col[~np.isnan(col)])[1]
        self._scaler = _Standard().fit(self._power(X))
        return self

    def _power(self, X):
        X = X.copy()
        with np.errstate(invalid="ignore"):
            for j, lmbda in enumerate(self.lambdas_):
                X[:, j] = stats.yeojohnson(X[:, j], lmbda)
        return X

    def transform(self, X):
        return self._scaler.transform(self._power(X))


_SCALERS = {
    "min_max": _MinMax,
    "standard": _Standard,
    "robust": _Robust,
    "power": _YeoJohnson,
}


def _dense_matrix(frame, dense_col):
    """The dense columns as one (rows, cols) float matrix: float32 or float64
    as the columns are, float64 for integer columns (scikit-learn's
    ``FLOAT_DTYPES`` rule)."""
    X = np.column_stack([column(frame, c) for c in dense_col])
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    return X


def process_data(
    data, dense_col=None, normalizer="min_max", transformer=("log", "sqrt", "square")
):
    """Normalize dense columns and optionally append transformed variants.

    ``data`` may be one column mapping or a (train, *rest) sequence of them;
    the scaler is fit on the first one only. Each mapping's dense columns
    are replaced by their float32 normalized values, and ``{col}_log``,
    ``{col}_sqrt`` and ``{col}_square`` are added where ``transformer``
    names them and the column holds no negative value. Returns ``(data,
    dense columns with the added names)``.
    """
    if not isinstance(dense_col, list):
        raise ValueError("dense_col must be a list...")
    if normalizer.lower() not in _SCALERS:
        raise ValueError("unknown normalize type...")
    scaler = _SCALERS[normalizer.lower()]()

    frames = data if isinstance(data, (list, tuple)) else [data]
    dense_col_transformed = dense_col.copy()
    for i, frame in enumerate(frames):
        X = _dense_matrix(frame, dense_col)
        if i == 0:
            scaler.fit(X)
        scaled = scaler.transform(X).astype(np.float32)
        for j, col in enumerate(dense_col):
            frame[col] = scaled[:, j]
        for col in dense_col:
            if frame[col].min() < 0.0:
                print("can't transform negative values...")
                continue
            for name, fn in (("log", np.log1p), ("sqrt", np.sqrt), ("square", np.square)):
                if transformer is not None and name in transformer:
                    new_col = f"{col}_{name}"
                    frame[new_col] = fn(frame[col])
                    if i == 0:
                        dense_col_transformed.append(new_col)
    return data, dense_col_transformed


def _is_missing(v):
    return v is None or (isinstance(v, float) and v != v)


def _split_value(v, sep, pad):
    """One multi-value cell as pandas' string methods treat it: stripped of
    ``sep`` and spaces at both ends, white space removed, lower-cased, an
    empty cell replaced by ``pad``, then split on ``sep`` (a regular
    expression when it is longer than one character). None for a missing
    or non-string cell."""
    if not isinstance(v, str):
        return None
    v = re.sub(r"\s+", "", v.strip(sep + " ")).lower()
    if v == "":
        v = pad
        if not isinstance(v, str):
            return None
    return v.split(sep) if len(sep) == 1 else re.split(sep, v)


def split_multi_value(
    data,
    multi_value_col,
    sep,
    max_len=None,
    pad_val="missing",
    user_col=None,
    item_col=None,
):
    """Expand delimiter-separated multi-value columns into padded
    sub-columns ``{col}_1`` ... ``{col}_{n}`` (``n`` the longest split, or
    ``max_len``), then fill every column's missing values with the first
    ``pad_val`` and drop the original columns.

    Returns (data, nested multi_sparse column names, user sub-columns, item
    sub-columns).
    """
    if max_len is not None:
        if not isinstance(max_len, (list, tuple)):
            raise ValueError("`max_len` must be list or tuple")
        if len(max_len) != len(multi_value_col):
            raise ValueError("`max_len` must have same length as `multi_value_col`")
    if not isinstance(pad_val, (list, tuple)):
        pad_val = [pad_val] * len(multi_value_col)
    if len(multi_value_col) != len(pad_val):
        raise ValueError("length of `multi_sparse_col` and `pad_val` doesn't match")

    user_sparse_col, item_sparse_col, multi_sparse_col = [], [], []
    for j, col in enumerate(multi_value_col):
        parts = [_split_value(v, sep, pad_val[j]) for v in column(data, col)]
        col_len = (max(len(p) for p in parts if p is not None)
                   if max_len is None else max_len[j])
        sub_cols = []
        for i in range(col_len):
            name = f"{col}_{i + 1}"
            sub_cols.append(name)
            cells = np.empty(len(parts), dtype=object)
            cells[:] = [p[i] if p is not None and i < len(p) else pad_val[j]
                        for p in parts]
            data[name] = cells
        multi_sparse_col.append(sub_cols)
        if user_col is not None and col in user_col:
            user_sparse_col.extend(sub_cols)
        elif item_col is not None and col in item_col:
            item_sparse_col.extend(sub_cols)

    names = [c for c in column_names(data) if c not in multi_value_col]
    data = data.drop(multi_value_col, axis=1) if hasattr(data, "drop") else {
        c: data[c] for c in names}
    for c in names:
        values = column(data, c)
        if values.dtype == object:
            missing = np.fromiter((_is_missing(v) for v in values), bool, len(values))
        elif values.dtype.kind == "f":
            missing = np.isnan(values)
        else:
            continue
        if missing.any():
            data = replace_where(data, c, missing, pad_val[0])
    return data, multi_sparse_col, user_sparse_col, item_sparse_col
