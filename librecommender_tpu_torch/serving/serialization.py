"""Serving artifacts, in the JAX package's layout.

Counterpart of ``librecommender_tpu/serving/serialization.py``: each saver
writes a directory of JSON and ``.npz`` files with the model name, the id
maps, the consumed lists and the model family's payload, under the same
names, keys and value types, so that an artifact saved by either package
hydrates (``store.py``) and serves (``app.py``) in the other:

- knn: the top-k similarity lists and the interaction CSR (UserCF, ItemCF,
  Swing);
- embed: the user and item embedding tables with their OOV rows (the
  ``EmbedBase`` family), and beside them, optionally, an IVF index;
- online: the whole model (``model.save``), which the server loads on first
  use for request-time ``seq`` and ``user_feats``.
"""
import json
from pathlib import Path

import numpy as np

from ..bases.cf_base import CfBase
from ..bases.embed_base import EmbedBase
from ..retrieval.ivf import IVFIndex


def _common(path, model):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    data_info = model.data_info
    with open(path / "model_meta.json", "w") as f:
        json.dump(
            {
                "model_name": model.model_name,
                "model_category": _category(model),
                "n_users": int(model.n_users),
                "n_items": int(model.n_items),
            },
            f, indent=2,
        )
    with open(path / "id_mapping.json", "w") as f:
        json.dump(
            {
                "user2id": {str(u): int(i) for u, i in data_info.user2id.items()},
                "id2item": {str(i): _py(v) for i, v in data_info.id2item.items()},
            },
            f,
        )
    with open(path / "user_consumed.json", "w") as f:
        json.dump(
            {str(u): [int(i) for i in items]
             for u, items in data_info.user_consumed.items()},
            f,
        )
    return path


def _py(v):
    return v.item() if isinstance(v, np.generic) else v


def _category(model):
    if isinstance(model, CfBase):
        return "knn"
    if isinstance(model, EmbedBase):
        return "embed"
    return "model"


def save_knn(path, model, k_sim=20):
    """The first ``k_sim`` neighbours of every row and the interaction CSR."""
    path = _common(path, model)
    np.savez_compressed(
        path / "knn_sims",
        sim_ids=model.sim_ids[:, :k_sim],
        sim_vals=model.sim_vals[:, :k_sim],
        cf_mode=np.asarray([model.cf_mode]),
    )
    np.savez_compressed(
        path / "interaction",
        data=model.interaction.data,
        indices=model.interaction.indices,
        indptr=model.interaction.indptr,
    )
    return path


def save_embed(path, model):
    """The user and item tables, each with its trailing OOV row."""
    path = _common(path, model)
    np.savez_compressed(
        path / "embeddings",
        user_embed=model.user_embeds_np,
        item_embed=model.item_embeds_np,
    )
    return path


def save_ivf_index(path, model, n_clusters=None, n_probe=8):
    """Build the IVF index over the item table (without its OOV row) on the
    model's device, where its Lloyd steps run the segment-sum kernel, and
    save it with ``ivf_config.json`` (the search's ``n_probe``). Returns the
    index."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    index = IVFIndex.build(
        model.item_embeds[:-1], n_clusters=n_clusters, seed=model.seed,
        device=model.device,
    )
    index.save(path)
    with open(path / "ivf_config.json", "w") as f:
        json.dump({"n_probe": n_probe}, f)
    return index


def save_online(path, model):
    """The whole model, beside the common files."""
    path = _common(path, model)
    model.save(str(path), model.model_name)
    return path
