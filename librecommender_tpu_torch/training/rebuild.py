"""Retrain-time grafting: old weights and optimizer moments into a model
built on an enlarged vocabulary.

Counterpart of ``librecommender_tpu/training/rebuild.py``. After
``merge_trainset`` gives a DataInfo with a bigger vocabulary (and its
``old_info`` snapshot), a new model's rows are overwritten with the old
trained rows:

- user/item tables: rows [0, old_n) copy over (appended ids keep their fresh
  initialisation); the old OOV row moves to the new OOV position;
- flat sparse tables: each field's block moves from its old offset to its
  new one (values are appended in order, so positions within a field hold);
  each field's old OOV row moves to its new OOV position;
- any other leaf of the same shape copies verbatim; a leaf whose shape
  changed under no rule keeps its fresh value.

Trees here are flat ``{npz key: array}`` mappings (``a/b#2/c``); a leaf's
name is its key's last dict key (``c``; ``b`` for ``a/b#2``), as the JAX
package's recursion names it. The optimizer's moments graft the same way,
leaf by leaf (``graft_opt_leaves``).
"""
import numpy as np

from ..utils.save_load import restore_opt_leaves

USER_ROW_KEYS = ("user_embed", "user_bias", "linear_user")
ITEM_ROW_KEYS = ("item_embed", "item_embed_in", "item_bias", "linear_item",
                 "context_embed")
SPARSE_ROW_KEYS = ("sparse_embed", "linear_sparse")


def leaf_name(key):
    """The dict key that names a flat key's leaf (``a/b#2/c`` -> ``c``)."""
    return key.rsplit("/", 1)[-1].split("#", 1)[0]


def _old_sparse_layout(old_info):
    """[(col_idx, old_offset, old_len, old_oov)] per real field."""
    layout = []
    offset = 0
    oov_iter = iter(old_info.sparse_oov)
    for col_idx, length in enumerate(old_info.sparse_len):
        if length == -1:
            continue  # a multi-sparse field's redundant sub-column
        layout.append((col_idx, offset, length, next(oov_iter)))
        offset += length + 1
    return layout


def _graft_rows(old, new, old_n, new_n):
    out = np.array(new)
    take = min(old_n, old.shape[0], out.shape[0])
    out[:take] = old[:take]
    # old OOV row -> new OOV position
    if old.shape[0] > old_n and out.shape[0] > new_n:
        out[new_n] = old[old_n]
    return out


def _graft_sparse_rows(old, new, old_info, data_info):
    out = np.array(new)
    new_offset = data_info.sparse_offset
    new_oov = data_info.sparse_oov
    for col_idx, old_off, old_len, old_oov in _old_sparse_layout(old_info):
        n_off = int(new_offset[col_idx])
        take = min(old_len, old.shape[0] - old_off)
        if take > 0:
            out[n_off : n_off + take] = old[old_off : old_off + take]
        if old_oov < old.shape[0] and int(new_oov[col_idx]) < out.shape[0]:
            out[int(new_oov[col_idx])] = old[old_oov]
    return out


def graft_leaf(name, old, new, data_info):
    """One leaf named ``name``: the old rows in the new layout."""
    old_info = data_info.old_info
    old, new = np.asarray(old), np.asarray(new)
    if name in USER_ROW_KEYS:
        return _graft_rows(old, new, old_info.n_users, data_info.n_users)
    if name in ITEM_ROW_KEYS:
        return _graft_rows(old, new, old_info.n_items, data_info.n_items)
    if name in SPARSE_ROW_KEYS:
        return _graft_sparse_rows(old, new, old_info, data_info)
    if old.shape == new.shape:
        return old
    return new  # shape changed and no rule: keep the fresh value


def graft_params(old_params, new_params, data_info):
    """Graft flat ``{key: array}`` parameters: every key of the new model,
    from the old one where it has the key."""
    return {
        k: graft_leaf(leaf_name(k), old_params[k], v, data_info)
        if k in old_params else np.asarray(v)
        for k, v in new_params.items()
    }


def graft_opt_leaves(old_leaves, fresh_leaves, layout, data_info):
    """Graft optimizer leaves (the JAX package's ``graft_opt_state`` on the
    leaf list). ``layout`` has one ``(key, params_like)`` per leaf: the
    parameter a moment leaf belongs to (None for a step count), and whether
    it sits in a subtree shaped as the whole parameter tree (Adam's and
    AMSGrad's moments over all parameters, SGD's trace), where every leaf is
    grafted by its name; elsewhere (the moments of the parameters outside
    the lazy-Adam tables, the tables' moments, WideDeep's masked states) a
    leaf of unchanged shape copies over and only a changed one is
    grafted."""
    out = []
    old_leaves = restore_opt_leaves(fresh_leaves, old_leaves)
    for old, new, (key, params_like) in zip(old_leaves, fresh_leaves, layout):
        old, new = np.asarray(old), np.asarray(new)
        if key is None or (not params_like and old.shape == new.shape):
            out.append(old)
        else:
            out.append(graft_leaf(leaf_name(key), old, new, data_info))
    return out
