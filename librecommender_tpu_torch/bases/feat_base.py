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

Request-time inputs: ``predict(feats=...)`` overrides one pair's user
features, ``recommend_user(user_feats=..., seq=...)`` one or more users'
features and histories; the override rows stay (users, F) / (users, L) and
repeat over the catalog on the device. Every inference path first re-uploads
the feature tables when ``DataInfo.assign_*_features`` changed them.
"""
import numpy as np
import torch

from .base import Base
from .embed_base import pointwise_rows
from ..ops.embeddings import combine_multi_sparse, dense_embeds
from ..ops.features import FeatureTables
from ..ops.losses import pointwise_loss
from ..ops.table_gather import table_lookup
from ..ops.topk import pad_consumed, topk_from_scores
from ..recommendation.cold_start import popular_recommendations
from ..recommendation.ranking import rank_recommendations
from ..utils.misc import aligned_rows

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
    def _forward(self, params, inputs, train):
        """inputs dict with (B,) 'user'/'item' (+ optional (B, L) 'seq') ->
        (B,) logits; ``params`` is the nested tree."""
        raise NotImplementedError

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
        sparse indices / dense values used (for the linear term). Optional
        "user_sparse_row" / "user_dense_row" entries (B, F_u) replace the
        stored user feature rows (request-time features); "sparse_row_full" /
        "dense_row_full" (B, F) replace every field (batched prediction with
        features)."""
        users, items = inputs["user"], inputs["item"]
        fields = [
            params["user_embed"][users][:, None, :],
            params["item_embed"][items][:, None, :],
        ]
        sparse_idx, dense_vals = None, None
        if self.feats.has_sparse:
            sparse_idx = inputs.get("sparse_row_full")
            if sparse_idx is None:
                sparse_idx = self.feats.sparse_for(
                    users, items, user_rows=inputs.get("user_sparse_row"))
            emb = self._train_lookup(params["sparse_embed"], sparse_idx)
            emb = combine_multi_sparse(
                emb, sparse_idx, self.feats.multi_sparse_info,
                self.multi_sparse_combiner,
            )
            fields.append(emb)
        if self.feats.has_dense:
            dense_vals = inputs.get("dense_row_full")
            if dense_vals is None:
                dense_vals = self.feats.dense_for(
                    users, items, user_rows=inputs.get("user_dense_row"))
            fields.append(dense_embeds(params["dense_embed"], dense_vals))
        return torch.cat(fields, dim=1), sparse_idx, dense_vals

    def _linear_term(self, params, users, items, sparse_idx, dense_vals):
        """The first-order term of FM / DeepFM / WideDeep's wide part: a
        weight per user, item and sparse index (every sparse column, raw
        multi-sparse ones included) and one per dense field."""
        out = (params["linear_bias"] + params["linear_user"][users]
               + params["linear_item"][items])
        if sparse_idx is not None:
            out = out + torch.sum(params["linear_sparse"][sparse_idx], dim=1)
        if dense_vals is not None:
            out = out + dense_vals @ params["linear_dense"]
        return out

    def _init_linear(self, u_rows, i_rows):
        """The first-order weights, all zeros."""
        p = {
            "linear_bias": torch.zeros((), device=self.device),
            "linear_user": torch.zeros((u_rows,), device=self.device),
            "linear_item": torch.zeros((i_rows,), device=self.device),
        }
        if self.feats.has_sparse:
            p["linear_sparse"] = torch.zeros((self._sparse_rows(),),
                                             device=self.device)
        if self.feats.has_dense:
            p["linear_dense"] = torch.zeros((self.feats.n_dense_fields,),
                                            device=self.device)
        return p

    def _sparse_rows(self):
        return aligned_rows(self.feats.sparse_vocab - 1)

    # -------------------------------------------------------------- training
    def loss_fn(self, params, batch):
        users, items, labels_all, weight_all = pointwise_rows(batch)
        point_loss = pointwise_loss(self.task, self.loss_type)
        S = batch["item_neg"].shape[1] if "item_neg" in batch else 0
        inputs = {"user": users, "item": items}
        for key in batch:
            if not key.startswith("seq"):
                continue
            if S and not getattr(self, "shared_seq", False):
                inputs[key] = torch.cat(
                    [batch[key], batch[key].repeat_interleave(S, dim=0)]
                )
            else:
                # with shared_seq, pos/neg targets share each row's history:
                # pass the (B, L) seq once; _forward fans targets out over it
                # (din_attention's multi-target form), which halves the seq
                # gather and its backward scatter-add
                inputs[key] = batch[key]
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
        """Rebuild the device's feature tables after
        ``DataInfo.assign_user_features`` / ``assign_item_features`` moved
        ``feature_version``."""
        version = getattr(self.data_info, "feature_version", 0)
        if self.feats is not None and self.feats.version != version:
            self.feats = FeatureTables(self.data_info, self.device)

    def _catalog_pair_inputs(self, users, overrides=None, items=None):
        """(U,) users -> flat cross-product inputs (U * n_items rows) for the
        generic pair scorer. Per-user override rows ((U, F) features) repeat
        over the catalog on the device. ``items``: optional (T,) item-id
        subset, defaults to the full catalog."""
        if items is None:
            items = torch.arange(self.n_items, device=self.device)
        n_items = items.shape[0]
        inputs = {
            "user": users.repeat_interleave(n_items),
            "item": items.repeat(users.shape[0]),
        }
        for key, val in (overrides or {}).items():
            if not key.startswith("seq"):
                inputs[key] = val.repeat_interleave(n_items, dim=0)
        return inputs

    def _catalog_seq(self, users, overrides=None, key="seq"):
        """Per-user history for a catalog scorer: the (U, L) request-time
        override when there is one, else the stored recent table
        (``key="seq_long"``: the long one) gathered on the device."""
        if overrides and overrides.get(key) is not None:
            return overrides[key]
        table = (self.recent_long_table if key == "seq_long"
                 else self.recent_seq_table)
        return table[users]

    @torch.no_grad()
    def _score_users(self, uids, overrides=None):
        """(U,) inner user ids -> (U, n_items) logits on the device.
        ``overrides``: numpy (U, F) feature rows / (U, L) histories by input
        key, for request-time features and sequences."""
        self._sync_feature_tables()
        users = self._to_device(uids)
        overrides = {key: self._to_device(val)
                     for key, val in (overrides or {}).items()}
        params = self._tree()
        if hasattr(self, "_score_catalog"):
            # model-provided full-catalog scorer: shares the
            # target-independent per-user work (e.g. the history's tokens)
            # across all items instead of recomputing it per pair
            return self._score_catalog(params, users, overrides)
        logits = self._forward(
            params, self._catalog_pair_inputs(users, overrides), train=False)
        return logits.reshape(users.shape[0], self.n_items)

    def _to_device(self, arr):
        """A host array as a device tensor: int64 (indices) or float32."""
        arr = np.asarray(arr)
        dtype = torch.float32 if arr.dtype.kind == "f" else torch.int64
        return torch.as_tensor(arr, dtype=dtype, device=self.device)

    def _sigmoid_or_clip(self, logits):
        if self.task == "rating":
            return np.clip(logits, self.lower_bound, self.upper_bound)
        return 1.0 / (1.0 + np.exp(-logits))

    @torch.no_grad()
    def predict(self, user, item, inner_id=False, cold_start="average",
                feats=None):
        """``feats``: optional {column: value} overrides of the user's
        features, for ONE pair (returns a float)."""
        self._sync_feature_tables()
        users, items = self.convert_ids(user, item, inner_id)
        params = self._tree()
        if feats is not None:
            if len(users) != 1:
                raise ValueError("`feats` prediction supports one pair, got "
                                 f"{len(users)}")
            uid = int(users[0])
            inputs = {"user": self._to_device(users), "item": self._to_device(items)}
            if self.feats.user_sparse is not None:
                row = self.feats.build_user_sparse_row(uid, feats)
                inputs["user_sparse_row"] = self._to_device(row[None])
            if self.feats.user_dense is not None:
                row = self.feats.build_user_dense_row(uid, feats)
                inputs["user_dense_row"] = self._to_device(row[None])
            logit = self._forward(params, inputs, train=False).cpu().numpy()
            return float(self._sigmoid_or_clip(logit)[0])
        out = []
        for start in range(0, len(users), _PREDICT_CHUNK):
            rows = slice(start, start + _PREDICT_CHUNK)
            inputs = {"user": self._to_device(users[rows]),
                      "item": self._to_device(items[rows])}
            out.append(self._forward(params, inputs, train=False).cpu().numpy())
        preds = self._sigmoid_or_clip(np.concatenate(out))
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
        for chunk, scores in self._chunked_scores(inner_ids[main_idx], None,
                                                  users_per_call):
            uids = inner_ids[main_idx[chunk]]
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
            for r, i in enumerate(main_idx[chunk]):
                result[_key(raw_users[i])] = ids[r]
        for i in np.nonzero(popular_mask)[0]:
            result[_key(raw_users[i])] = popular_recommendations(
                self.data_info, inner_id=True, n_rec=n_rec
            )
        return self.finalize_rec(result, raw_users, inner_id)

    def _chunked_scores(self, uids, overrides, users_per_call=None):
        """Yield (slice of ``uids``, (chunk, n_items) logits) over chunks of
        users. ``users_per_call=None`` starts at the learned cap and halves
        it when the card runs out of memory, remembering the new cap."""
        U = users_per_call if users_per_call is not None else self._users_per_call_cap
        start = 0
        while start < len(uids):
            chunk = slice(start, start + U)
            part = {key: val[chunk] for key, val in (overrides or {}).items()}
            try:
                scores = self._score_users(uids[chunk], part)
            except torch.cuda.OutOfMemoryError:
                if U <= 1:
                    raise
                U = max(1, len(uids[chunk]) // 2)
                self._users_per_call_cap = U
                torch.cuda.empty_cache()
                continue
            yield slice(start, start + len(uids[chunk])), scores
            start += len(uids[chunk])

    def _recommend_dynamic(self, user, n_rec, inner_id, filter_consumed,
                           user_feats, seq):
        """Score the catalog for one or more users with request-time feature
        and sequence overrides.

        ``user_feats``: one dict applied to every user, or a list of dicts
        (one per user). ``seq``: one item list shared by every user, or a
        list of per-user lists. Users without an override keep their stored
        rows; unknown users score through the OOV rows."""
        self._sync_feature_tables()
        users = np.atleast_1d(np.asarray(user))
        U = len(users)

        def _per_user(val):
            if val is None:
                return [None] * U
            if isinstance(val, dict):
                return [val] * U
            if isinstance(val, (list, tuple)) and U > 1:
                if len(val) != U:
                    raise ValueError(
                        f"per-user overrides need one entry per user: got "
                        f"{len(val)} for {U} users"
                    )
                return list(val)
            return [val] * U if U > 1 else [val]

        feats_list = _per_user(user_feats)
        if seq is not None and U > 1:
            # list of lists = per-user sequences; a flat list = shared
            if not (isinstance(seq, (list, tuple))
                    and seq and isinstance(seq[0], (list, tuple, np.ndarray))):
                seq = [seq] * U
            elif len(seq) != U:
                raise ValueError(
                    f"per-user seq needs one list per user: got {len(seq)} "
                    f"for {U} users"
                )
        seq_list = [seq] * U if U == 1 else (seq if seq is not None else [None] * U)

        uids = np.empty(U, np.int64)
        for i, u in enumerate(users):
            if inner_id:
                uids[i] = int(u) if 0 <= int(u) < self.n_users else self.n_users
            else:
                uids[i] = self.data_info.user2id.get(u, self.n_users)

        # per-user override rows, (U, F) / (U, L): never repeated over the
        # catalog on the host (the scorers do that on the device)
        overrides = {}
        if any(f is not None for f in feats_list):
            for key, table, build in (
                ("user_sparse_row", self.data_info.user_sparse_unique,
                 self.feats.build_user_sparse_row),
                ("user_dense_row", self.data_info.user_dense_unique,
                 self.feats.build_user_dense_row),
            ):
                if table is None:
                    continue
                overrides[key] = np.stack([
                    build(int(uid), f) if f is not None
                    else np.asarray(table)[int(uid)]
                    for uid, f in zip(uids, feats_list)
                ])
        if any(s is not None for s in seq_list):
            overrides.update(self._request_seq_overrides(uids, seq_list, inner_id))

        result = {}
        for chunk, scores in self._chunked_scores(uids, overrides):
            consumed = (
                pad_consumed(self.user_consumed, uids[chunk],
                             n_rec=int(n_rec), n_items=self.n_items)
                if filter_consumed else None
            )
            ids, _ = topk_from_scores(scores, consumed, int(n_rec))
            ids = ids.cpu().numpy()
            for r, i in enumerate(range(chunk.start, chunk.stop)):
                result[_key(users[i])] = ids[r]
        return self.finalize_rec(result, users, inner_id)

    def _request_seq_overrides(self, uids, seq_list, inner_id):
        """Per-user request seqs -> {"seq": (U, L)}; users without one keep
        their stored recent history. Models without a behavior sequence
        ignore request seqs; dual-seq models (SIM) split the windows."""
        if getattr(self, "recent_seq_table", None) is None:
            return {}
        table = None
        rows = []
        for uid, s in zip(uids, seq_list):
            if s is None:
                if table is None:
                    table = self.recent_seq_table.cpu().numpy()
                rows.append(table[int(uid)])
            else:
                rows.append(self._convert_request_seq(s, inner_id))
        return {"seq": np.stack(rows).astype(np.int64)}

    def _convert_request_seq(self, seq, inner_id, max_len=None):
        """Raw item list -> right-aligned, padded inner-id array."""
        L = max_len or getattr(self, "max_seq_len", len(seq))
        if inner_id:
            ids = [int(i) for i in seq if 0 <= int(i) < self.n_items]
        else:
            ids = [self.data_info.item2id[i] for i in seq
                   if i in self.data_info.item2id]
        ids = ids[-L:]
        out = np.full(L, self.n_items, np.int64)
        if ids:
            out[L - len(ids):] = ids
        return out

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
