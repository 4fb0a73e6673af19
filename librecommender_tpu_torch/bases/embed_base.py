"""Base for models reducible to a (user_embeds, item_embeds) dot product.

Counterpart of ``librecommender_tpu/bases/embed_base.py``: exported
embeddings with a trailing OOV row (the mean of the trained rows), known and
cold-user recommendation through the streaming top-k, and inference-only
save/load. The exported tables are kept twice: as host numpy arrays
(``user_embeds_np``/``item_embeds_np``, bit-identical to the JAX package's)
and as float32 tensors on the model's device (``user_embeds``/
``item_embeds``), which scoring reads. Approximate and knn search come later.
"""
from pathlib import Path

import numpy as np
import torch

from .base import Base
from ..ops.topk import topk_from_embeddings
from ..recommendation.cold_start import popular_recommendations
from ..recommendation.ranking import rank_recommendations


class EmbedBase(Base):
    def __init__(self, task, data_info, embed_size, lower_upper_bound=None,
                 seed=42, device=None):
        super().__init__(task, data_info, lower_upper_bound, seed, device)
        self.embed_size = embed_size
        self.user_embeds_np = None  # (n_users + 1, D) with trailing OOV row
        self.item_embeds_np = None  # (n_items + 1, D)
        self.user_embeds = None     # the same tables on self.device
        self.item_embeds = None

    # -------------------------------------------------------------- contract
    def set_embeddings(self):
        """Compute the exported tables from ``self.net``.

        Implementations pass arrays WITHOUT the OOV row to
        :meth:`_set_exported`, which appends it as the mean of trained rows.
        """
        raise NotImplementedError

    def post_fit(self):
        self.set_embeddings()
        self.build_default_recs()

    def _append_oov(self, embeds):
        oov = np.mean(embeds, axis=0, keepdims=True)
        return np.vstack([embeds, oov]).astype(np.float32)

    def _set_exported(self, user_np, item_np):
        """Store host tables (OOV rows included) and their device copies."""
        self.user_embeds_np = user_np
        self.item_embeds_np = item_np
        self.user_embeds = torch.from_numpy(user_np).to(self.device)
        self.item_embeds = torch.from_numpy(item_np).to(self.device)

    def _default_rec_source(self, num):
        """Cold 'average' recs = top items for the OOV (mean) user."""
        ids, _ = topk_from_embeddings(
            self.user_embeds[-1], self.item_embeds[:-1],
            min(num, self.n_items), filter_consumed=False,
        )
        return ids[0]

    # ------------------------------------------------------------- inference
    def predict(self, user, item, inner_id=False, cold_start="average"):
        user, item = self.convert_ids(user, item, inner_id)
        u = torch.as_tensor(user, device=self.device)
        i = torch.as_tensor(item, device=self.device)
        preds = (self.user_embeds[u] * self.item_embeds[i]).sum(dim=1)
        preds = preds.cpu().numpy()
        if self.task == "rating":
            preds = np.clip(preds, self.lower_bound, self.upper_bound)
        else:
            preds = 1.0 / (1.0 + np.exp(-preds))
        return preds[0] if np.isscalar(user) or preds.size == 1 else preds

    def recommend_user(
        self,
        user,
        n_rec,
        inner_id=False,
        cold_start="average",
        filter_consumed=True,
        random_rec=False,
    ):
        raw_users = np.atleast_1d(np.asarray(user))
        if cold_start not in ("average", "popular"):
            raise ValueError(f"Unknown cold start strategy: {cold_start}")
        inner_ids = np.empty(len(raw_users), dtype=np.int64)
        popular_mask = np.zeros(len(raw_users), dtype=bool)
        for i, u in enumerate(raw_users):
            if inner_id:
                uid = int(u) if 0 <= int(u) < self.n_users else -1
            else:
                uid = self.data_info.user2id.get(u, -1)
            if uid < 0:
                popular_mask[i] = cold_start == "popular"
                inner_ids[i] = self.n_users  # OOV (average) row
            else:
                inner_ids[i] = uid

        result = {}
        main_idx = np.nonzero(~popular_mask)[0]
        if main_idx.size > 0:
            uids = inner_ids[main_idx]
            if random_rec:
                scores = self.user_embeds_np[uids] @ self.item_embeds_np[:-1].T
                ids = rank_recommendations(
                    self.task,
                    uids,
                    scores,
                    n_rec,
                    self.n_items,
                    self.user_consumed,
                    filter_consumed=filter_consumed,
                    random_rec=True,
                    np_rng=self.data_info.np_rng,
                )
            else:
                ids, _ = topk_from_embeddings(
                    self.user_embeds[torch.as_tensor(uids, device=self.device)],
                    self.item_embeds[:-1],
                    n_rec,
                    user_consumed=self.user_consumed if filter_consumed else None,
                    user_ids=uids,
                    filter_consumed=filter_consumed,
                )
            for row, i in enumerate(main_idx):
                result[_key(raw_users[i])] = ids[row]
        for i in np.nonzero(popular_mask)[0]:
            result[_key(raw_users[i])] = popular_recommendations(
                self.data_info, inner_id=True, n_rec=n_rec
            )
        return self.finalize_rec(result, raw_users, inner_id)

    # ----------------------------------------------------------- embeddings
    def get_user_embedding(self, user=None, include_bias=False):
        embeds = self.user_embeds_np[:-1] if user is None else self.user_embeds_np[
            self.convert_ids(user, user, False)[0]
        ]
        return embeds if include_bias else embeds[..., : self.embed_size]

    def get_item_embedding(self, item=None, include_bias=False):
        embeds = self.item_embeds_np[:-1] if item is None else self.item_embeds_np[
            self.convert_ids(item, item, False)[1]
        ]
        return embeds if include_bias else embeds[..., : self.embed_size]

    # --------------------------------------------------------- persistence
    def save(self, path, model_name=None, inference_only=False, **kwargs):
        if model_name is not None:
            self.model_name = model_name
        if inference_only:
            Path(path).mkdir(parents=True, exist_ok=True)
            np.savez_compressed(
                Path(path) / f"{self.model_name}_embeddings",
                user_embed=self.user_embeds_np,
                item_embed=self.item_embeds_np,
            )
            from ..utils.save_load import save_default_recs, save_hyper_params

            save_hyper_params(path, self)
            save_default_recs(path, self)
            self.data_info.save(path, self.model_name)
        else:
            super().save(path, model_name=self.model_name)

    @classmethod
    def load(cls, path, model_name, data_info=None, device=None, **kwargs):
        embed_path = Path(path) / f"{model_name}_embeddings.npz"
        if embed_path.exists():
            from ..data.data_info import DataInfo
            from ..utils.save_load import load_default_recs, load_hyper_params

            if data_info is None:
                data_info = DataInfo.load(path, model_name)
            hparams = load_hyper_params(path, model_name)
            hparams.pop("model_class", None)
            model = cls(data_info=data_info, device=device, **hparams)
            model.model_name = model_name
            with np.load(embed_path) as arrays:
                model._set_exported(arrays["user_embed"], arrays["item_embed"])
            model.default_recs = load_default_recs(path, model_name)
            model.loaded = True
            return model
        return super().load(path, model_name, data_info, device, **kwargs)

    def post_load(self):
        if self.net is not None:
            self.set_embeddings()


def _key(u):
    """Dict keys: keep raw user hashable/scalar."""
    return u.item() if isinstance(u, np.generic) else u
