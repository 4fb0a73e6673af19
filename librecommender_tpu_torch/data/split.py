"""Data splitting, without pandas.

Counterpart of ``random_split``, ``split_by_ratio`` and
``split_by_ratio_chrono`` in ``librecommender_tpu/data/split.py``. Each takes
a column mapping (see ``columns.py``) and returns the same kind of mapping.
"""
import math

import numpy as np

from .columns import column, column_names, n_rows, replace_where, take_rows


def random_split(
    data,
    shuffle=True,
    test_size=None,
    multi_ratios=None,
    filter_unknown=True,
    pad_unknown=False,
    pad_val=None,
    seed=42,
):
    """Split rows randomly into 2+ parts.

    Examples
    --------
    >>> train, test = random_split(data, test_size=0.2)
    >>> train, evals, test = random_split(data, multi_ratios=[0.8, 0.1, 0.1])
    """
    ratios, _ = _check_and_convert_ratio(test_size, multi_ratios)
    n = n_rows(data)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n) if shuffle else np.arange(n)
    boundaries = np.round(np.cumsum(ratios)[:-1] * n).astype(int)
    parts = np.split(order, boundaries)
    split_data_all = [take_rows(data, np.sort(p) if not shuffle else p) for p in parts]
    return _handle_unknown(split_data_all, filter_unknown, pad_unknown, pad_val)


def split_by_ratio(
    data,
    order=True,
    shuffle=False,
    test_size=None,
    multi_ratios=None,
    filter_unknown=True,
    pad_unknown=False,
    pad_val=None,
    seed=42,
):
    """Assign a ratio of every user's items to each split (rare users with
    <= 3 interactions stay fully in train)."""
    if "user" not in column_names(data):
        raise ValueError("data must contain user column")
    ratios, n_splits = _check_and_convert_ratio(test_size, multi_ratios)

    user_split_indices = _groupby_user(column(data, "user"), order)
    cum_ratios = np.cumsum(ratios).tolist()[:-1]
    split_indices_all = [[] for _ in range(n_splits)]
    for u_data in user_split_indices:
        u_len = len(u_data)
        if u_len <= 3:
            split_indices_all[0].extend(u_data)
        else:
            boundaries = [round(cum * u_len) for cum in cum_ratios]
            for i, part in enumerate(np.split(u_data, boundaries)):
                split_indices_all[i].extend(part.tolist())

    if shuffle:
        np_rng = np.random.default_rng(seed)
        split_data_all = [take_rows(data, np_rng.permutation(idx))
                          for idx in split_indices_all]
    else:
        split_data_all = [take_rows(data, idx) for idx in split_indices_all]
    return _handle_unknown(split_data_all, filter_unknown, pad_unknown, pad_val)


def split_by_ratio_chrono(
    data, order=True, shuffle=False, test_size=None, multi_ratios=None, seed=42
):
    """Like :func:`split_by_ratio`, with rows sorted by a ``time`` column
    first: pandas' ``sort_values(by=["time"])``, which is numpy's unstable
    quicksort argsort, so tied times keep pandas' order."""
    names = column_names(data)
    if "user" not in names or "time" not in names:
        raise ValueError("data must contain user and time column")
    by_time = np.argsort(column(data, "time"), kind="quicksort")
    data = take_rows(data, by_time, reset_index=True)
    return split_by_ratio(data, order, shuffle, test_size, multi_ratios, seed=seed)


def _handle_unknown(split_data_all, filter_unknown, pad_unknown, pad_val):
    if filter_unknown:
        return _filter_unknown_user_item(split_data_all)
    if pad_unknown and pad_val is not None:
        return _pad_unknown_user_item(split_data_all, pad_val)
    return split_data_all


def _isin(values, reference):
    """``values`` found in ``reference``, by hash for object arrays."""
    if values.dtype == object or reference.dtype == object:
        ref = set(reference.tolist())
        return np.fromiter((v in ref for v in values.tolist()), bool, len(values))
    return np.isin(values, reference)


def _known(train_data, test_data, name):
    return _isin(column(test_data, name), np.unique(column(train_data, name)))


def _filter_unknown_user_item(data_list):
    """Drop eval/test rows whose user or item never appears in train."""
    train_data = data_list[0]
    result = [train_data]
    for test_data in data_list[1:]:
        known = (_known(train_data, test_data, "user")
                 & _known(train_data, test_data, "item"))
        result.append(take_rows(test_data, np.nonzero(known)[0]))
    return result


def _pad_unknown_user_item(data_list, pad_val):
    if isinstance(pad_val, (list, tuple)):
        user_pad_val, item_pad_val = pad_val
    else:
        user_pad_val = item_pad_val = pad_val
    train_data = data_list[0]
    result = [train_data]
    for test_data in data_list[1:]:
        unknown_user = ~_known(train_data, test_data, "user")
        unknown_item = ~_known(train_data, test_data, "item")
        test_data = replace_where(test_data, "user", unknown_user, user_pad_val)
        test_data = replace_where(test_data, "item", unknown_item, item_pad_val)
        result.append(test_data)
    return result


def _groupby_user(user_indices, order):
    """Row positions grouped per user; stable within a user if order=True."""
    sort_kind = "mergesort" if order else "quicksort"
    _, user_position, user_counts = np.unique(
        user_indices, return_inverse=True, return_counts=True
    )
    return np.split(
        np.argsort(user_position, kind=sort_kind), np.cumsum(user_counts)[:-1]
    )


def _check_and_convert_ratio(test_size, multi_ratios):
    if not test_size and not multi_ratios:
        raise ValueError("must provide either 'test_size' or 'multi_ratios'")
    if test_size is not None:
        if not isinstance(test_size, float) or not 0.0 < test_size < 1.0:
            raise ValueError("test_size must be a float in (0.0, 1.0)")
        return [1 - test_size, test_size], 2
    if isinstance(multi_ratios, (list, tuple)):
        if len(multi_ratios) < 2:
            raise ValueError("multi_ratios must at least have two elements")
        if not all(r > 0.0 for r in multi_ratios):
            raise ValueError("ratios should be positive values")
        total = math.fsum(multi_ratios)
        ratios = [r / total for r in multi_ratios] if total != 1.0 else list(multi_ratios)
        return ratios, len(ratios)
    raise ValueError("multi_ratios should be list or tuple")
