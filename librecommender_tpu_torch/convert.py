"""Carry model weights between the JAX package's saved layout and the port.

The JAX package saves a model's parameters as a tree of numpy arrays
(``{name}_params.npz``, see ``utils/save_load.py``). These functions check
that layout and turn it into tensors on a device, and back.
"""
import numpy as np
import torch

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
