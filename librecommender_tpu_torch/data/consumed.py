"""Consumed-interaction bookkeeping, in numpy.

Counterpart of ``librecommender_tpu/data/consumed.py``:
``user_consumed[u]`` lists the items user ``u`` interacted with in row
order, with consecutive duplicates removed within the user's own
subsequence; ``item_consumed[i]`` lists each item's users the same way. Keys
come in the order of each group's first row, as pandas'
``groupby(sort=False)`` gives them. ``update_consumed`` merges a retrain's
lists into an old DataInfo's.
"""
import numpy as np


def grouped_in_first_appearance(keys, values, keep=None):
    """``{key: [values of its rows, in row order]}`` over the rows where
    ``keep`` holds, keys in the order of their first row."""
    keys = np.asarray(keys)
    values = np.asarray(values)
    if keep is not None:
        keys, values = keys[keep], values[keep]
    order = np.argsort(keys, kind="stable")
    sk, sv = keys[order], values[order]
    uniq, start, counts = np.unique(sk, return_index=True, return_counts=True)
    first_row = order[start]
    out = {}
    for g in np.argsort(first_row, kind="stable"):
        s = start[g]
        out[int(uniq[g])] = sv[s:s + counts[g]].tolist()
    return out


def _keep_non_repeats(group, member):
    """Rows whose ``member`` differs from the previous row of the same
    ``group`` (a group's first row is kept)."""
    order = np.argsort(group, kind="stable")
    sg, sm = group[order], member[order]
    keep_sorted = np.ones(len(group), bool)
    keep_sorted[1:] = ~((sg[1:] == sg[:-1]) & (sm[1:] == sm[:-1]))
    keep = np.empty(len(group), bool)
    keep[order] = keep_sorted
    return keep


def interaction_consumed(user_indices, item_indices):
    users = np.asarray(user_indices)
    items = np.asarray(item_indices)
    user_consumed = grouped_in_first_appearance(
        users, items, _keep_non_repeats(users, items))
    item_consumed = grouped_in_first_appearance(
        items, users, _keep_non_repeats(items, users))
    return user_consumed, item_consumed


def update_consumed(user_indices, item_indices, n_users, n_items, old_info,
                    merge_behavior):
    """Consumed lists over the merged vocabulary: with ``merge_behavior``
    the old list followed by the new one, otherwise the new list where there
    is one and the old one elsewhere."""
    user_consumed, item_consumed = interaction_consumed(user_indices, item_indices)
    combine = _merge_dedup if merge_behavior else _fill_empty
    return (combine(user_consumed, n_users, old_info.user_consumed),
            combine(item_consumed, n_items, old_info.item_consumed))


def _merge_dedup(new_consumed, num, old_consumed):
    result = {}
    for i in range(num):
        assert i in new_consumed or i in old_consumed
        if i in new_consumed and i in old_consumed:
            result[i] = old_consumed[i] + new_consumed[i]
        else:
            result[i] = new_consumed[i] if i in new_consumed else old_consumed[i]
    return result


def _fill_empty(consumed, num, old_consumed):
    return {i: consumed[i] if i in consumed else old_consumed[i] for i in range(num)}
