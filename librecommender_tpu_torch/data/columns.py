"""Column access for the data functions, with or without pandas.

The port's data functions take any column mapping: a dict of equal-length
1-D arrays, or a pandas DataFrame where pandas is installed. They read it
only through ``data.keys()`` and ``np.asarray(data[col])``, and these helpers
return rows of the same kind of mapping they were given.
"""
import numpy as np


def column_names(data):
    return list(data.keys())


def column(data, name, dtype=None):
    return np.asarray(data[name], dtype=dtype)


def n_rows(data):
    names = column_names(data)
    return len(data[names[0]]) if names else 0


def take_rows(data, idx, reset_index=False):
    """The rows ``idx`` of ``data``, as the same kind of mapping: a
    DataFrame's ``iloc`` (its index kept unless ``reset_index``), or a dict
    of the arrays' rows."""
    idx = np.asarray(idx, dtype=np.int64)
    if hasattr(data, "iloc"):
        out = data.iloc[idx]
        return out.reset_index(drop=True) if reset_index else out
    return {k: np.asarray(v)[idx] for k, v in data.items()}


def replace_where(data, name, mask, value):
    """A copy of ``data`` whose column ``name`` holds ``value`` where
    ``mask``; the column turns to object dtype when ``value`` does not fit
    its numeric dtype (as a pandas column would)."""
    if hasattr(data, "loc"):
        out = data.copy()
        out.loc[mask, name] = value
        return out
    col = np.asarray(data[name])
    val = np.asarray(value)
    if col.dtype.kind in "biuf" and val.dtype.kind in "biuf":
        col = col.astype(np.result_type(col.dtype, val.dtype), copy=True)
    else:
        col = col.astype(object, copy=True)
    col[np.asarray(mask, bool)] = value
    out = dict(data)
    out[name] = col
    return out


def last_rows(data, name):
    """The last row of each value of column ``name``, in row order (pandas'
    ``drop_duplicates(subset=[name], keep="last")``), index reset."""
    ids = column(data, name)
    _, first_from_end = np.unique(ids[::-1], return_index=True)
    return take_rows(data, np.sort(len(ids) - 1 - first_from_end),
                     reset_index=True)
