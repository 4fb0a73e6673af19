"""Carry model weights between the JAX package's saved layout and the port.

The JAX package saves a model's parameters as a tree of numpy arrays
(``{name}_params.npz``, see ``utils/save_load.py``). These functions check
that layout and turn it into tensors on a device, and back.
"""
import numpy as np
import torch

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
