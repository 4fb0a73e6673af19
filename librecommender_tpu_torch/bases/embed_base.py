"""Base for models reducible to a (user_embeds, item_embeds) dot product.

Counterpart of ``librecommender_tpu/bases/embed_base.py``: exported
embeddings with a trailing OOV row (the mean of the trained rows), known and
cold-user recommendation through the streaming top-k, inference-only
save/load, and the tables re-exported after every epoch (``post_epoch``).
The exported tables are kept twice: as host numpy arrays
(``user_embeds_np``/``item_embeds_np``, bit-identical to the JAX package's)
and as float32 tensors on the model's device (``user_embeds``/
``item_embeds``), which scoring reads.

Approximate retrieval: ``init_ann`` builds an IVF index on the model's
device (``retrieval/ivf.py``: k-means and search through the port's kernels)
or an HNSW graph on the host (``retrieval/hnsw.py``), which
``recommend_user`` then searches. ``init_knn`` sets the space for
``search_knn_users`` / ``search_knn_items``: exact search on the device
through the streaming top-k, or HNSW graphs on the host.

Parameters: a model gives its nested tree in the JAX package's layout
(``_init_params``); ``Base`` keeps it flat in ``self.net``.
"""
from pathlib import Path

import numpy as np
import torch

from .base import Base
from ..ops.streaming_topk import streaming_topk
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
        self.ann = None             # optional approximate index (init_ann)
        self.ann_n_probe = 8

    # -------------------------------------------------------------- contract
    def set_embeddings(self):
        """Compute the exported tables from ``self.net``.

        Implementations pass arrays WITHOUT the OOV row to
        :meth:`_set_exported`, which appends it as the mean of trained rows.
        """
        raise NotImplementedError

    def post_epoch(self):
        self.set_embeddings()

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
            if self.ann is not None and not random_rec:
                ids = self._ann_recommend(uids, n_rec, filter_consumed)
            elif random_rec:
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

    # ------------------------------------------------------------------ ANN
    def init_ann(self, index="ivf", n_clusters=None, n_probe=8, iters=20,
                 M=16, ef_construction=200, ef_search=200):
        """Build an approximate index over the item embeddings, which later
        ``recommend_user`` calls search (over-fetching to cover consumed
        filtering) instead of scoring the full catalog.

        ``index``: "ivf" (k-means inverted lists on the model's device, the
        serving tier's format) or "hnsw" (the host graph index)."""
        if self.item_embeds_np is None:
            raise ValueError("fit or load the model first")
        if index == "hnsw":
            from ..retrieval.hnsw import HNSWIndex

            self.ann = HNSWIndex.build(
                self.item_embeds_np[:-1], M=M,
                ef_construction=ef_construction, seed=self.seed,
            )
            self._ann_search_kw = {"ef_search": ef_search}
        else:
            from ..retrieval.ivf import IVFIndex

            self.ann = IVFIndex.build(
                self.item_embeds[:-1], n_clusters=n_clusters, iters=iters,
                seed=self.seed, device=self.device,
            )
            self._ann_search_kw = {"n_probe": n_probe}
        return self.ann

    def _ann_recommend(self, uids, n_rec, filter_consumed):
        """The index's top ``n_rec`` plus the batch's longest consumed list,
        consumed items dropped; a row left short is filled from the popular
        items, which are not filtered (as in the JAX package)."""
        max_consumed = max(
            (len(self.user_consumed.get(int(u), ())) for u in uids), default=0
        )
        fetch = n_rec + (max_consumed if filter_consumed else 0)
        ids, _ = self.ann.search(
            self.user_embeds[torch.as_tensor(uids, device=self.device)], fetch,
            **getattr(self, "_ann_search_kw", {"n_probe": 8}),
        )
        out = np.empty((len(uids), n_rec), np.int64)
        for r, u in enumerate(uids):
            consumed = (
                set(self.user_consumed.get(int(u), ())) if filter_consumed else ()
            )
            picked = [i for i in ids[r] if i >= 0 and i not in consumed][:n_rec]
            if len(picked) < n_rec:  # popular fallback fill
                pops = popular_recommendations(
                    self.data_info, inner_id=True, n_rec=n_rec + len(picked)
                )
                picked.extend(p for p in pops if p not in set(picked))
            out[r] = picked[:n_rec]
        return out

    # ----------------------------------------------------------- embeddings
    def get_user_id(self, user):
        """Raw user -> inner id; an unknown user raises."""
        if user not in self.data_info.user2id:
            raise ValueError(f"unknown user: {user}")
        return self.data_info.user2id[user]

    def get_item_id(self, item):
        """Raw item -> inner id; an unknown item raises."""
        if item not in self.data_info.item2id:
            raise ValueError(f"unknown item: {item}")
        return self.data_info.item2id[item]

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

    def init_knn(self, approximate, sim_type="cosine", M=100,
                 ef_construction=200, ef_search=200):
        """Set the knn-search space.

        ``sim_type='cosine'`` searches normalized factor embeddings (bias
        excluded); ``'inner-product'`` searches the full exported embeddings,
        bias included. ``approximate=True`` builds an HNSW graph a side on
        the host (``M`` capped at 64); otherwise searches are exact, on the
        model's device.
        """
        if sim_type not in ("cosine", "inner-product"):
            raise ValueError(
                f"unknown sim_type: {sim_type}, "
                "only `cosine` and `inner-product` are supported"
            )
        self.sim_type = sim_type
        self.include_bias = sim_type == "inner-product"
        self.knn_approximate = bool(approximate)
        if approximate:
            from ..retrieval.hnsw import HNSWIndex

            self._knn_ef_search = ef_search
            self._knn_indexes = {}
            for side in ("user", "item"):
                base = self._knn_space(side)
                self._knn_indexes[side] = HNSWIndex.build(
                    base, M=min(M, 64), ef_construction=ef_construction,
                    seed=self.seed,
                )
        return self

    def _knn_space(self, side, on_device=False):
        """Embedding matrix (no OOV row) in the active knn space: host numpy
        (the HNSW graphs' input, as the JAX package computes it), or with
        ``on_device`` a tensor on the model's device."""
        if on_device:
            base = (self.user_embeds if side == "user" else self.item_embeds)[:-1]
        else:
            base = (self.user_embeds_np if side == "user"
                    else self.item_embeds_np)[:-1]
        if not getattr(self, "include_bias", False):
            base = base[:, : self.embed_size]
        if getattr(self, "sim_type", "inner-product") == "cosine":
            if on_device:
                norm = torch.linalg.vector_norm(base, dim=1, keepdim=True)
                base = base / norm.clamp_min(1e-12)
            else:
                base = base / np.maximum(
                    np.linalg.norm(base, axis=1, keepdims=True), 1e-12)
        return base

    def _search_knn(self, side, inner_id, k):
        if getattr(self, "knn_approximate", False):
            base = self._knn_space(side)
            ids, _ = self._knn_indexes[side].search(
                base[inner_id][None], k + 1, ef_search=self._knn_ef_search
            )
            top = [int(t) for t in ids[0] if t >= 0]
        else:   # exact, through the streaming top-k
            base = self._knn_space(side, on_device=True).contiguous()
            ids, _ = streaming_topk(base[inner_id][None], base,
                                    min(k + 1, base.shape[0]))
            top = ids[0].cpu().numpy()
        return [int(t) for t in top if t != inner_id][:k]

    def search_knn_users(self, user, k):
        """k most similar users (self excluded) in the ``init_knn`` space
        (exact inner product when ``init_knn`` was not called); None for an
        unknown user."""
        uid = self.data_info.user2id.get(user)
        if uid is None:
            return None
        return [
            self.data_info.id2user[t] for t in self._search_knn("user", uid, k)
        ]

    def search_knn_items(self, item, k):
        """k most similar items (self excluded), as ``search_knn_users``."""
        iid = self.data_info.item2id.get(item)
        if iid is None:
            return None
        return [
            self.data_info.id2item[t] for t in self._search_knn("item", iid, k)
        ]

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


def pointwise_rows(batch):
    """A pointwise batch's rows with its sampled negatives appended: (users,
    items, labels, weight), B positives then B * S negatives, a row's S in
    order, labelled 1 and 0."""
    users, items, labels, weight = (
        batch["user"], batch["item"], batch["label"], batch["weight"],
    )
    if "item_neg" not in batch:
        return users, items, labels, weight
    neg = batch["item_neg"]                                      # (B, S)
    S = neg.shape[1]
    return (
        torch.cat([users, users.repeat_interleave(S)]),
        torch.cat([items, neg.reshape(-1)]),
        torch.cat([torch.ones_like(labels), labels.new_zeros(neg.numel())]),
        torch.cat([weight, weight.repeat_interleave(S)]),
    )


def _key(u):
    """Dict keys: keep raw user hashable/scalar."""
    return u.item() if isinstance(u, np.generic) else u
