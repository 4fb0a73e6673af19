"""Carry model state between the JAX package's saved layout and the port.

The JAX package saves a model's parameters as a tree of numpy arrays
(``{name}_params.npz``, see ``utils/save_load.py``), its optimizer state as
optax leaves in tree-flatten order, and a neighbourhood model's state as
neighbour lists beside the interaction CSR (``{name}_cf.npz``). These
functions check that layout and turn it into the port's tensors or arrays,
and back.
"""
import numpy as np
import torch
from scipy.sparse import csr_matrix

from .utils.save_load import flatten_tree

BPR_KEYS = ("user_embed", "item_embed")


def bpr_params_from_jax(params, device):
    """BPR parameters as saved by either package -> float32 tensors.

    ``params``: ``{"user_embed": (R_u, D), "item_embed": (R_i, D + 1)}``, the
    item table holding the item bias in its last column.
    """
    if sorted(params) != sorted(BPR_KEYS):
        raise ValueError(f"BPR params need keys {BPR_KEYS}, got {sorted(params)}")
    user, item = (np.asarray(params[k]) for k in BPR_KEYS)
    if user.ndim != 2 or item.ndim != 2 or item.shape[1] != user.shape[1] + 1:
        raise ValueError(
            f"BPR tables must be (R_u, D) and (R_i, D + 1), got {user.shape} "
            f"and {item.shape}"
        )
    return {
        k: torch.tensor(v, dtype=torch.float32, device=device)
        for k, v in zip(BPR_KEYS, (user, item))
    }


def bpr_params_to_jax(tensors):
    """BPR tensors (a mapping such as an ``nn.ParameterDict``) -> the saved
    tree of float32 numpy arrays."""
    return {
        k: tensors[k].detach().to("cpu", torch.float32).numpy() for k in BPR_KEYS
    }


def tree_params_from_jax(params, shapes, device):
    """A nested parameter tree as saved by either package (dicts and lists
    with array leaves, e.g. DIN's ``att/mlp/layers#0/dense/w``) -> one flat
    ``{npz key: float32 tensor}`` mapping on ``device``.

    ``shapes``: ``{npz key: shape}`` the model expects; a tree with other
    keys or shapes was saved under other hyper-parameters or data and is
    refused. A flat mapping keyed by the npz names is a tree too.
    """
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    if set(flat) != set(shapes):
        odd = sorted(set(flat) ^ set(shapes))
        raise ValueError(f"parameter keys differ from the model's: {odd}")
    for k, v in flat.items():
        if tuple(v.shape) != tuple(shapes[k]):
            raise ValueError(
                f"parameter {k} has shape {v.shape}, the model expects {shapes[k]}"
            )
    return {k: torch.tensor(flat[k], dtype=torch.float32, device=device)
            for k in shapes}


def tree_params_to_jax(tensors):
    """The flat ``{npz key: tensor}`` mapping -> float32 numpy arrays under
    the same keys; ``save_params`` writes them as they are, and
    ``unflatten_tree`` gives the JAX package's nested tree."""
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in tensors.items()}


def cf_state_from_jax(sim_ids, sim_vals, interaction):
    """A neighbourhood model's state as the JAX package holds it
    (``sim_ids`` (n_rows, k) padded with -1, ``sim_vals`` (n_rows, k), the
    user-item interaction CSR) -> ``(int32 ids, float32 sims, float32
    CSR)`` for ``CfBase.set_cf_state``."""
    ids = np.asarray(sim_ids)
    sims = np.asarray(sim_vals)
    if ids.ndim != 2 or ids.shape != sims.shape:
        raise ValueError(f"sim_ids {ids.shape} and sim_vals {sims.shape} must be "
                         "one (n_rows, k) shape")
    inter = csr_matrix(interaction)
    return (np.ascontiguousarray(ids, np.int32),
            np.ascontiguousarray(sims, np.float32),
            csr_matrix((np.asarray(inter.data, np.float32), inter.indices,
                        inter.indptr), shape=inter.shape))


def opt_leaves_from_jax(leaves):
    """An optax state's leaves (``jax.tree_util.tree_leaves`` of it, on the
    host) -> the numpy leaf list the port's trainer restores
    (``model._initial_opt_state = ("restore", ("leaves", leaves))``):
    counts int32, moments float32."""
    out = []
    for v in leaves:
        a = np.asarray(v)
        out.append(a.astype(np.int32) if np.issubdtype(a.dtype, np.integer)
                   else a.astype(np.float32))
    return out
