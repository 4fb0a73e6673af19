"""Base for feature/CTR models scored by a full forward pass.

Counterpart of ``librecommender_tpu/bases/feat_base.py``. Subclasses
implement ``_init_params`` and ``_forward``; feature gathering happens inside
``_forward`` through the device-resident ``FeatureTables``. Full-catalog
scoring for ``recommend_user`` runs on the device a chunk of users at a time
and is ranked by ``ops.topk.topk_from_scores``.

Parameters: ``self.net`` is one flat ``nn.ParameterDict`` keyed by the saved
npz names (``att/mlp/layers#0/dense/w``), which is what the trainer, early
stopping and persistence iterate over; ``loss_fn`` and the inference paths
hand ``_forward`` the nested view of it (``unflatten_tree``), whose leaves
are the same tensors, so ``ops/nn.py`` reads the JAX package's tree.

Waiting for the feature family (ROADMAP 1.8): the first-order term of
FM/WideDeep, ``predict(feats=...)``, request-time ``user_feats``/``seq`` in
``recommend_user`` and the re-upload after a feature update.
"""
import numpy as np
import torch
from torch import nn

from .base import Base
from ..convert import tree_params_from_jax, tree_params_to_jax
from ..ops.embeddings import combine_multi_sparse, dense_embeds
from ..ops.features import FeatureTables
from ..ops.losses import bce_loss, focal_loss, mse_loss
from ..ops.table_gather import table_lookup
from ..ops.topk import pad_consumed, topk_from_scores
from ..recommendation.cold_start import popular_recommendations
from ..recommendation.ranking import rank_recommendations
from ..utils.misc import aligned_rows
from ..utils.save_load import flatten_tree, unflatten_tree

_PREDICT_CHUNK = 4096

#: ``_train_lookup`` sends a lookup through the gather and segment-sum kernels
#: when its table has at most this many rows, whatever the ids per row (a
#: table of a few rows has its ids summed in segments). Every block of the
#: segment-sum reads all the ids, so its cost grows with the rows; beyond the
#: bound plain indexing, whose backward on the card (``index_put_`` with
#: accumulate) sorts the ids and is deterministic too. The bound is where
#: ``chip_smoke.py``'s lookup timing puts the crossing on an H100 (PERF.md).
LOOKUP_MAX_ROWS = 262_144


class FeatBase(Base):
    paradigm = "pointwise"

    def __init__(
        self,
        task,
        data_info,
        loss_type="cross_entropy",
        embed_size=16,
        n_epochs=20,
        lr=0.001,
        lr_decay=False,
        epsilon=1e-5,
        reg=None,
        batch_size=256,
        sampler="random",
        num_neg=1,
        seed=42,
        lower_upper_bound=None,
        multi_sparse_combiner="sqrtn",
        device=None,
    ):
        super().__init__(task, data_info, lower_upper_bound, seed, device)
        if task == "ranking" and loss_type not in ("cross_entropy", "focal"):
            raise ValueError(f"ranking takes cross_entropy or focal loss, "
                             f"got {loss_type!r}")
        self.loss_type = loss_type
        self.embed_size = embed_size
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        self.reg = reg
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_neg = num_neg
        self.multi_sparse_combiner = multi_sparse_combiner
        self.feats = None
        self._dropout_gen = None
        self._users_per_call_cap = 64

    # row-sparse lazy Adam opt-in for huge vocab tables (set the attribute
    # or pass sparse_optimizer=True where a model exposes it, e.g. DIN):
    # embedding tables and their Adam moments update only batch-touched rows
    sparse_optimizer = False

    @property
    def sparse_tables(self):
        tabs = ["user_embed", "item_embed"]
        if self.feats is not None and self.feats.has_sparse:
            tabs.append("sparse_embed")
        return tuple(t for t in tabs if t in (self.net or {}))

    def touched_indices(self, batch):
        users, items = batch["user"], batch["item"]
        if "item_neg" in batch:
            neg = batch["item_neg"]
            users_all = torch.cat([users, users.repeat_interleave(neg.shape[1])])
            items_all = torch.cat([items, neg.reshape(-1)])
        else:
            users_all, items_all = users, items
        out = {"user_embed": users_all, "item_embed": items_all}
        if self.feats is not None and self.feats.has_sparse:
            out["sparse_embed"] = self.feats.sparse_for(
                users_all, items_all
            ).reshape(-1)
        return out

    # -------------------------------------------------------------- building
    def build_model(self):
        """Random parameters from the seed."""
        self.build_model_shell()
        self.net = nn.ParameterDict({
            k: nn.Parameter(v) for k, v in flatten_tree(self._fresh_params()).items()
        })

    def _fresh_params(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return self._init_params(gen)

    def _init_params(self, generator):
        """The nested parameter tree, in the JAX package's layout."""
        raise NotImplementedError

    def _forward(self, params, inputs, train):
        """inputs dict with (B,) 'user'/'item' (+ optional (B, L) 'seq') ->
        (B,) logits; ``params`` is the nested tree."""
        raise NotImplementedError

    def params_from_arrays(self, params):
        if self.feats is None:
            self.build_model_shell()
        shapes = {k: tuple(v.shape)
                  for k, v in flatten_tree(self._fresh_params()).items()}
        self.net = nn.ParameterDict({
            k: nn.Parameter(v)
            for k, v in tree_params_from_jax(params, shapes, self.device).items()
        })

    def params_to_arrays(self):
        return tree_params_to_jax(self.net)

    def _tree(self, params=None):
        """The nested view of the flat parameters (the same tensors)."""
        return unflatten_tree(dict((self.net if params is None else params).items()))

    # ------------------------------------------------------- shared compute
    @property
    def n_fields(self):
        """Static field count after multi-sparse combining: user + item +
        sparse fields + dense fields."""
        f_sparse = self.feats.n_sparse_fields
        info = self.feats.multi_sparse_info
        if info is not None and self.multi_sparse_combiner != "normal":
            f_sparse = f_sparse - int(sum(info.field_len)) + len(info.field_len)
        return 2 + f_sparse + self.feats.n_dense_fields

    # set by the Trainer for the duration of a fit on the GPU: table lookups
    # that pass the size gate then go through the gather kernel, so that
    # their gradient is the deterministic segment-sum kernel
    _mxu_lookup = False

    def _train_lookup(self, table, idx):
        """table[idx], through the gather kernel when enabled and the table
        passes the gate (``LOOKUP_MAX_ROWS``)."""
        use = self._mxu_lookup and table.shape[0] <= LOOKUP_MAX_ROWS
        return table_lookup(table, idx, use)

    def _field_embeds(self, params, inputs):
        """inputs dict -> field embedding cube (B, n_fields, D) plus the raw
        sparse indices / dense values used."""
        users, items = inputs["user"], inputs["item"]
        fields = [
            params["user_embed"][users][:, None, :],
            params["item_embed"][items][:, None, :],
        ]
        sparse_idx, dense_vals = None, None
        if self.feats.has_sparse:
            sparse_idx = self.feats.sparse_for(users, items)
            emb = self._train_lookup(params["sparse_embed"], sparse_idx)
            emb = combine_multi_sparse(
                emb, sparse_idx, self.feats.multi_sparse_info,
                self.multi_sparse_combiner,
            )
            fields.append(emb)
        if self.feats.has_dense:
            dense_vals = self.feats.dense_for(users, items)
            fields.append(dense_embeds(params["dense_embed"], dense_vals))
        return torch.cat(fields, dim=1), sparse_idx, dense_vals

    def _linear_term(self, params, users, items, sparse_idx, dense_vals):
        raise NotImplementedError(
            "the first-order term of FM / WideDeep comes with the feature "
            "family (ROADMAP 1.8)"
        )

    def _init_linear(self, generator, u_rows, i_rows):
        raise NotImplementedError(
            "the first-order term of FM / WideDeep comes with the feature "
            "family (ROADMAP 1.8)"
        )

    def _sparse_rows(self):
        return aligned_rows(self.feats.sparse_vocab - 1)

    # -------------------------------------------------------------- training
    def loss_fn(self, params, batch):
        users, items, labels, weight = (
            batch["user"], batch["item"], batch["label"], batch["weight"],
        )
        point_loss = mse_loss if self.task == "rating" else (
            bce_loss if self.loss_type == "cross_entropy" else focal_loss
        )
        if "item_neg" in batch:
            neg = batch["item_neg"]
            S = neg.shape[1]
            inputs = {
                "user": torch.cat([users, users.repeat_interleave(S)]),
                "item": torch.cat([items, neg.reshape(-1)]),
            }
            for key in batch:
                if key.startswith("seq"):
                    if getattr(self, "shared_seq", False):
                        # pos/neg targets share each row's history: pass the
                        # (B, L) seq once; _forward fans targets out over it
                        # (din_attention's multi-target form), which halves
                        # the seq gather and its backward scatter-add
                        inputs[key] = batch[key]
                    else:
                        inputs[key] = torch.cat(
                            [batch[key], batch[key].repeat_interleave(S, dim=0)]
                        )
            labels_all = torch.cat(
                [torch.ones_like(labels), labels.new_zeros(neg.numel())]
            )
            weight_all = torch.cat([weight, weight.repeat_interleave(S)])
        else:
            inputs = {"user": users, "item": items}
            for key in batch:
                if key.startswith("seq"):
                    inputs[key] = batch[key]
            labels_all, weight_all = labels, weight
        tree = self._tree(params)
        logits = self._forward(tree, inputs, train=True)
        loss = point_loss(logits, labels_all, weight_all)
        if self.reg:
            loss = loss + self.reg * self._reg_term(
                tree, inputs["user"], inputs["item"])
        return loss

    def _reg_term(self, params, users, items):
        """L2 over the embeddings gathered for this batch."""
        total = 0.0
        n = users.shape[0]
        if "user_embed" in params:
            total = total + torch.sum(torch.square(params["user_embed"][users]))
        if "item_embed" in params:
            total = total + torch.sum(torch.square(params["item_embed"][items]))
        if "sparse_embed" in params and self.feats.has_sparse:
            idx = self.feats.sparse_for(users, items)
            total = total + torch.sum(torch.square(params["sparse_embed"][idx]))
        return total / n

    # ------------------------------------------------------------- inference
    def _sync_feature_tables(self):
        raise NotImplementedError(
            "re-uploading the feature tables after a feature update comes "
            "with the feature family (ROADMAP 1.8)"
        )

    def _catalog_pair_inputs(self, users, items=None):
        """(U,) users -> flat cross-product inputs (U * n_items rows) for the
        generic pair scorer. ``items``: optional (T,) item-id subset,
        defaults to the full catalog."""
        if items is None:
            items = torch.arange(self.n_items, device=self.device)
        return {
            "user": users.repeat_interleave(items.shape[0]),
            "item": items.repeat(users.shape[0]),
        }

    def _catalog_seq(self, users, key="seq"):
        """Per-user history for a catalog scorer: the stored recent table
        (``key="seq_long"``: the long one) gathered on the device."""
        table = (self.recent_long_table if key == "seq_long"
                 else self.recent_seq_table)
        return table[users]

    @torch.no_grad()
    def _score_users(self, uids):
        """(U,) inner user ids -> (U, n_items) logits on the device."""
        users = torch.as_tensor(np.asarray(uids), dtype=torch.int64,
                                device=self.device)
        params = self._tree()
        if hasattr(self, "_score_catalog"):
            # model-provided full-catalog scorer: shares the
            # target-independent per-user work (e.g. the history's tokens)
            # across all items instead of recomputing it per pair
            return self._score_catalog(params, users)
        logits = self._forward(params, self._catalog_pair_inputs(users), train=False)
        return logits.reshape(users.shape[0], self.n_items)

    @torch.no_grad()
    def predict(self, user, item, inner_id=False, cold_start="average",
                feats=None):
        if feats is not None:
            raise NotImplementedError(
                "predict(feats=...) comes with the feature family (ROADMAP 1.8)"
            )
        users, items = self.convert_ids(user, item, inner_id)
        params = self._tree()
        out = []
        for start in range(0, len(users), _PREDICT_CHUNK):
            inputs = {
                key: torch.as_tensor(ids[start:start + _PREDICT_CHUNK],
                                     dtype=torch.int64, device=self.device)
                for key, ids in (("user", users), ("item", items))
            }
            out.append(self._forward(params, inputs, train=False).cpu().numpy())
        preds = np.concatenate(out)
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
        users_per_call=None,
        user_feats=None,
        seq=None,
    ):
        """``users_per_call=None`` sizes the chunk of users scored per pass
        by itself: it starts at 64 catalogs a pass and halves when the card
        runs out of memory (the catalog scorers materialize
        O(users x n_items x seq) activations, so the chunk that fits depends
        on the model and the catalog). The learned cap is remembered on the
        instance."""
        if user_feats is not None or seq is not None:
            return self._recommend_dynamic(user, n_rec, inner_id,
                                           filter_consumed, user_feats, seq)
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
                inner_ids[i] = self.n_users  # OOV feature row
            else:
                inner_ids[i] = uid

        result = {}
        main_idx = np.nonzero(~popular_mask)[0]
        if users_per_call is not None and users_per_call < 1:
            raise ValueError(f"users_per_call must be >= 1, got {users_per_call}")
        U = users_per_call if users_per_call is not None else self._users_per_call_cap
        start = 0
        while start < len(main_idx):
            chunk = main_idx[start : start + U]
            uids = inner_ids[chunk]
            try:
                scores = self._score_users(uids)
            except torch.cuda.OutOfMemoryError:
                if U <= 1:
                    raise
                U = max(1, len(uids) // 2)
                self._users_per_call_cap = U
                torch.cuda.empty_cache()
                continue
            if random_rec:
                ids = rank_recommendations(
                    self.task,
                    uids,
                    scores.cpu().numpy(),
                    n_rec,
                    self.n_items,
                    self.user_consumed,
                    filter_consumed=filter_consumed,
                    random_rec=True,
                    np_rng=self.data_info.np_rng,
                )
            else:
                consumed = (
                    pad_consumed(self.user_consumed, uids,
                                 n_rec=int(n_rec), n_items=self.n_items)
                    if filter_consumed else None
                )
                ids, _ = topk_from_scores(scores, consumed, int(n_rec))
                ids = ids.cpu().numpy()
            for r, i in enumerate(chunk):
                result[_key(raw_users[i])] = ids[r]
            start += len(chunk)
        for i in np.nonzero(popular_mask)[0]:
            result[_key(raw_users[i])] = popular_recommendations(
                self.data_info, inner_id=True, n_rec=n_rec
            )
        return self.finalize_rec(result, raw_users, inner_id)

    def _recommend_dynamic(self, user, n_rec, inner_id, filter_consumed,
                           user_feats, seq):
        raise NotImplementedError(
            "request-time user_feats / seq in recommend_user come with the "
            "feature family (ROADMAP 1.8)"
        )

    def _default_rec_source(self, num):
        """Cold 'average': score the catalog through the OOV feature row."""
        scores = self._score_users(np.full((1,), self.n_users))[0].cpu().numpy()
        return np.argsort(-scores)[: min(num, self.n_items)]

    def post_fit(self):
        # inference gathers contiguous id ranges: plain indexing
        self._mxu_lookup = False
        self.build_default_recs()

    def post_load(self):
        self.build_model_shell()

    def build_model_shell(self):
        """Rebuild static state (feature tables, the dropout generator)
        without touching the parameters."""
        self.feats = FeatureTables(self.data_info, self.device)
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(self.seed)


def _key(u):
    return u.item() if isinstance(u, np.generic) else u
