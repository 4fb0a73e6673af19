"""Model persistence, in the JAX package's on-disk format.

A model is three artifacts, read and written the same way by both packages:

- ``{name}_hyper_params.json`` - init kwargs captured from ``all_args``
- ``{name}_params.npz``        - the params tree flattened to path -> array
- DataInfo's own files         - via ``DataInfo.save``

Paths of the flattened tree are ``a/b#2/c``: dict keys joined by ``/``, list
positions as ``#i``. A trained model also writes ``{name}_opt_state.npz``, its
optimizer state as optax leaves in tree-flatten order
(``training/opt_state.py``). Only JSON and npz are read: nothing is
unpickled, so the JAX package's legacy pickle artifacts raise.
"""
import json
from pathlib import Path

import numpy as np


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return v


def save_hyper_params(path, model, extra=None):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    hparams = {k: _jsonable(v) for k, v in model.all_args.items()}
    hparams["model_class"] = model.__class__.__name__
    if extra:
        hparams.update({k: _jsonable(v) for k, v in extra.items()})
    with open(path / f"{model.model_name}_hyper_params.json", "w") as f:
        json.dump(hparams, f, indent=2)


def load_hyper_params(path, model_name):
    with open(Path(path) / f"{model_name}_hyper_params.json") as f:
        return json.load(f)


def refuse_pickle(path, what):
    """Raise for a legacy pickle artifact: it holds the JAX package's
    objects, which the port does not unpickle."""
    raise ValueError(
        f"{path} is a legacy pickle {what} of the JAX package, which the port "
        "does not read; load it in the JAX package and save it again (npz)"
    )


def flatten_tree(tree, prefix=""):
    """Flatten a dict/list/tuple tree to ``{path: leaf}``."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}#{i}"))
    else:
        out[prefix] = tree
    return out


def unflatten_tree(flat):
    """Rebuild the nested dict/list structure from ``{path: leaf}``.
    Tuples come back as lists."""
    root = {}
    for path, leaf in flat.items():
        # split "a/b#2/c" into tokens: ('a',), ('b',), (2,), ('c',)
        node = root
        tokens = []
        for seg in path.split("/"):
            parts = seg.split("#")
            tokens.append(("k", parts[0]))
            tokens.extend(("i", int(p)) for p in parts[1:])
        for t, (kind, key) in enumerate(tokens[:-1]):
            nxt_kind = tokens[t + 1][0]
            default = {} if nxt_kind == "k" else []
            if kind == "k":
                node = node.setdefault(key, default)
            else:
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = default
                node = node[key]
        kind, key = tokens[-1]
        if kind == "k":
            node[key] = leaf
        else:
            while len(node) <= key:
                node.append(None)
            node[key] = leaf
    return root


def save_params(path, model_name, params):
    """Persist a tree of host numpy arrays as a flat npz."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    np.savez(path / f"{model_name}_params.npz", **flat)


def load_params(path, model_name):
    """The saved tree of numpy arrays."""
    with np.load(Path(path) / f"{model_name}_params.npz") as data:
        return unflatten_tree({k: data[k] for k in data.files})


def save_opt_state(path, model_name, leaves):
    """Persist optimizer state as an npz of leaves in tree-flatten order
    (the structure comes from code on restore, the data from the npz)."""
    arrays = {f"leaf_{i:05d}": np.asarray(v) for i, v in enumerate(leaves)}
    np.savez(Path(path) / f"{model_name}_opt_state.npz", **arrays)


def load_opt_state(path, model_name):
    """``("leaves", [arrays])`` from the npz, or None if no optimizer state
    was saved; a legacy pickle raises."""
    p = Path(path) / f"{model_name}_opt_state.npz"
    if p.exists():
        with np.load(p) as data:
            return "leaves", [data[k] for k in sorted(data.files)]
    legacy = Path(path) / f"{model_name}_opt_state.pkl"
    if legacy.exists():
        refuse_pickle(legacy, "optimizer state")
    return None


def restore_opt_leaves(fresh_leaves, leaves):
    """Saved leaves in place of a freshly initialised state's (same count
    and shapes by construction), as numpy arrays."""
    if len(fresh_leaves) != len(leaves):
        raise ValueError(
            f"saved optimizer state has {len(leaves)} leaves but the fresh "
            f"state has {len(fresh_leaves)}; optimizer configuration "
            "changed between save and load"
        )
    return [np.asarray(v) for v in leaves]


def save_default_recs(path, model):
    if model.default_recs is not None:
        np.savez_compressed(
            Path(path) / f"{model.model_name}_default_recs",
            default_recs=np.asarray(model.default_recs),
        )


def load_default_recs(path, model_name):
    p = Path(path) / f"{model_name}_default_recs.npz"
    if p.exists():
        return np.load(p)["default_recs"]
    return None
