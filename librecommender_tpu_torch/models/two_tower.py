"""TwoTower: a dual encoder with in-batch softmax.

Counterpart of ``librecommender_tpu/models/two_tower.py``, with the same
constructor kwargs and parameter tree. The user and item towers are MLPs
(layer norm where ``use_bn``) over the id embedding and the side's sparse
(multi-sparse groups pooled inside the tower) and dense field embeddings;
their output width is ``hidden_units[-1]``. Losses: ``softmax`` in-batch
with the log-popularity correction from ``item_probs``, ``temperature`` and
accidental-hit removal, plus the SSL contrastive term between two masked
item-feature views (``rfm``, ``rfm-complementary``, ``cfm``, its masks from
``_ssl_masks``); ``cross_entropy`` and ``max_margin`` over sampled
negatives. ``compute_dtype="bf16"`` runs the tower MLPs in bfloat16 with
float32 outputs. After a fit both towers are exported as embeddings, so
``recommend_user`` is the streaming top-k; with request-time ``user_feats``
the user vector goes through the tower again and is ranked by
``topk_from_scores``.
"""
import numpy as np
import torch

from ..bases.embed_base import EmbedBase, _key
from ..data.data_info import MultiSparseInfo
from ..ops.embeddings import combine_multi_sparse
from ..ops.features import FeatureTables
from ..ops.initializers import truncated_normal
from ..ops.losses import bce_loss, max_margin_loss, softmax_cross_entropy_loss, ssl_loss
from ..ops.nn import init_mlp, l2_normalize, mlp
from ..ops.topk import pad_consumed, topk_from_scores
from ..recommendation.cold_start import popular_recommendations
from ..recommendation.ranking import rank_recommendations
from ..utils.misc import aligned_rows

_TOWER_CHUNK = 1024


def mutual_info_score(labels_a, labels_b):
    """scikit-learn's ``mutual_info_score`` of two label arrays, in nats,
    computed as it computes it (its contingency table's non-zero cells in
    row-major order, the same float64 operations), so that equal inputs give
    bit-equal scores."""
    classes_a, idx_a = np.unique(labels_a, return_inverse=True)
    classes_b, idx_b = np.unique(labels_b, return_inverse=True)
    if len(classes_a) == 1 or len(classes_b) == 1:
        return 0.0
    table = np.zeros((len(classes_a), len(classes_b)), np.int64)
    np.add.at(table, (idx_a.ravel(), idx_b.ravel()), 1)
    nzx, nzy = np.nonzero(table)
    nz_val = table[nzx, nzy]
    contingency_sum = table.sum()
    pi = table.sum(axis=1)
    pj = table.sum(axis=0)
    log_contingency_nm = np.log(nz_val)
    contingency_nm = nz_val / contingency_sum
    outer = pi.take(nzx).astype(np.int64, copy=False) * pj.take(nzy).astype(
        np.int64, copy=False)
    log_outer = -np.log(outer) + np.log(pi.sum()) + np.log(pj.sum())
    mi = (contingency_nm * (log_contingency_nm - np.log(contingency_sum))
          + contingency_nm * log_outer)
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def cfm_field_order(table):
    """(F, F) int32: for each seed field, every field ordered by mutual
    information with it, highest first (the diagonal counts 0)."""
    F = table.shape[1]
    mi = np.zeros((F, F))
    for a in range(F):
        for b in range(F):
            if a != b:
                mi[a, b] = mutual_info_score(table[:, a], table[:, b])
    return np.argsort(-mi, axis=1).astype(np.int32)


class TwoTower(EmbedBase):
    def __init__(
        self,
        task,
        data_info,
        loss_type="softmax",
        embed_size=16,
        norm_embed=False,
        n_epochs=20,
        lr=0.001,
        lr_decay=False,
        epsilon=1e-5,
        reg=None,
        batch_size=256,
        sampler="random",
        num_neg=1,
        use_bn=True,
        dropout_rate=None,
        hidden_units=(128, 64, 32),
        margin=1.0,
        use_correction=True,
        temperature=1.0,
        remove_accidental_hits=False,
        ssl_pattern=None,
        ssl_alpha=0.2,
        ssl_temperature=0.1,
        alpha=None,  # the reference's name for ssl_alpha
        multi_sparse_combiner="sqrtn",
        sparse_optimizer=False,
        compute_dtype="f32",
        seed=42,
        device=None,
    ):
        # `device` stays out of all_args: the JAX package loads the saved
        # hyper-params as kwargs and has no such argument
        self.all_args = {
            k: v for k, v in locals().items()
            if k not in ("self", "__class__", "data_info", "device")
        }
        if task != "ranking":
            raise ValueError("TwoTower is only suitable for ranking")
        if loss_type not in ("cross_entropy", "max_margin", "softmax"):
            raise ValueError(f"unknown loss_type for TwoTower: {loss_type!r}")
        if compute_dtype not in ("bf16", "f32", None):
            raise ValueError("compute_dtype must be 'bf16', 'f32' or None")
        if ssl_pattern is not None:
            if ssl_pattern not in ("rfm", "rfm-complementary", "cfm"):
                raise ValueError(f"unknown ssl_pattern: {ssl_pattern!r}")
            if loss_type != "softmax":
                raise ValueError("SSL requires softmax loss")
        super().__init__(task, data_info, embed_size, None, seed, device)
        self.loss_type = loss_type
        self.norm_embed = norm_embed
        self.compute_dtype = compute_dtype or "f32"
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        self.reg = reg
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_neg = num_neg
        self.use_bn = use_bn
        self.dropout_rate = dropout_rate or 0.0
        self.hidden_units = tuple(hidden_units)
        self.use_correction = use_correction
        self.temperature = temperature
        self.remove_accidental_hits = remove_accidental_hits
        self.ssl_pattern = ssl_pattern
        self.ssl_alpha = ssl_alpha if alpha is None else alpha
        self.ssl_temperature = ssl_temperature
        self.margin = margin
        # lazy Adam over the id and feature tables (the trainer's contract:
        # sparse_tables + touched_indices)
        self.sparse_optimizer = sparse_optimizer
        self.multi_sparse_combiner = multi_sparse_combiner
        self.feats = None
        self.item_probs = None
        self.item_field_oov = None
        self.cfm_order = None
        self._dropout_gen = None
        if loss_type == "softmax":
            self.paradigm = "listwise"
        elif loss_type == "max_margin":
            self.paradigm = "pairwise"

    # ------------------------------------------------------------- building
    def build_model_shell(self):
        """The feature tables, the items' sampling probabilities, the SSL
        state and the dropout and mask generator."""
        self.feats = FeatureTables(self.data_info, self.device)
        counts = np.ones(self.n_items, np.float64)
        for i, users in self.data_info.item_consumed.items():
            counts[int(i)] += len(set(users))
        self.item_probs = torch.from_numpy(
            (counts / counts.sum()).astype(np.float32)).to(self.device)
        if self.ssl_pattern is not None:
            self._build_ssl_state()
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(self.seed)

    def _build_ssl_state(self):
        """Each item field's OOV index and, for cfm, the fields ordered by
        mutual information."""
        positions = self.feats.item_sparse_pos
        if not positions:
            raise ValueError("SSL requires item sparse features")
        self.item_field_oov = torch.as_tensor(
            np.asarray(self.data_info.sparse_oov)[positions], dtype=torch.int64,
            device=self.device)
        if self.ssl_pattern == "cfm":
            table = np.asarray(self.data_info.item_sparse_unique)[:, : len(positions)]
            self.cfm_order = torch.from_numpy(cfm_field_order(table)).to(self.device)

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
            rows = self.feats.sparse_for(users_all, items_all).reshape(-1)
            if self.ssl_pattern is not None:
                # the masked views embed each field's OOV row every step
                rows = torch.cat([rows, self.item_field_oov])
            out["sparse_embed"] = rows
        return out

    def _side_ms_info(self, is_user):
        """The multi-sparse groups of one tower's fields, in its local field
        order, so that groups pool inside the tower."""
        feats = self.feats
        info = feats.multi_sparse_info
        if info is None or self.multi_sparse_combiner == "normal":
            return None
        pos = feats.user_sparse_pos if is_user else feats.item_sparse_pos
        pos_to_local = {p: j for j, p in enumerate(pos)}
        offs, lens, oovs = [], [], []
        for g, (o, ln) in enumerate(zip(info.field_offset, info.field_len)):
            if o in pos_to_local:
                # a group's fields are contiguous and on one side
                assert all(o + t in pos_to_local for t in range(ln))
                offs.append(pos_to_local[o])
                lens.append(ln)
                oovs.append(np.asarray(info.feat_oov)[g])
        if not offs:
            return None
        return MultiSparseInfo(offs, lens, np.asarray(oovs), info.pad_val)

    def _n_tower_fields(self, is_user):
        feats = self.feats
        n_sp = len(feats.user_sparse_pos if is_user else feats.item_sparse_pos)
        side_info = self._side_ms_info(is_user)
        if side_info is not None:
            n_sp = n_sp - int(sum(side_info.field_len)) + len(side_info.field_len)
        n_d = len(feats.user_dense_pos if is_user else feats.item_dense_pos)
        return 1 + n_sp + n_d

    def _init_params(self, generator):
        D = self.embed_size
        params = {
            "user_embed": truncated_normal(generator, (aligned_rows(self.n_users), D)),
            "item_embed": truncated_normal(generator, (aligned_rows(self.n_items), D)),
        }
        if self.feats.has_sparse:
            params["sparse_embed"] = truncated_normal(
                generator, (aligned_rows(self.feats.sparse_vocab - 1), D))
        if self.feats.has_dense:
            params["dense_embed"] = truncated_normal(
                generator, (self.feats.n_dense_fields, D))
        # the tower's output is hidden_units[-1] wide, no projection to D
        for side, is_user in (("user_mlp", True), ("item_mlp", False)):
            params[side] = init_mlp(generator, self._n_tower_fields(is_user) * D,
                                    list(self.hidden_units), use_ln=self.use_bn)
        return params

    # --------------------------------------------------------------- towers
    def _tower(self, params, side, ids, train, sparse_rows, dense_rows):
        feats = self.feats
        is_user = side == "user"
        sparse = feats.user_sparse if is_user else feats.item_sparse
        dense = feats.user_dense if is_user else feats.item_dense
        pieces = [params[f"{side}_embed"][ids]]
        if sparse is not None:
            idx = sparse[ids] if sparse_rows is None else sparse_rows   # (B, F)
            emb = combine_multi_sparse(
                params["sparse_embed"][idx], idx, self._side_ms_info(is_user),
                self.multi_sparse_combiner)
            pieces.append(emb.reshape(idx.shape[0], -1))
        if dense is not None:
            vals = dense[ids] if dense_rows is None else dense_rows     # (B, F_d)
            pos = feats.user_dense_pos if is_user else feats.item_dense_pos
            emb = params["dense_embed"][pos]
            pieces.append((vals[:, :, None] * emb[None]).reshape(vals.shape[0], -1))
        x = torch.cat(pieces, dim=1)
        mlp_params = params[f"{side}_mlp"]
        if self.compute_dtype == "bf16":
            x = x.to(torch.bfloat16)
            mlp_params = _cast_tree(mlp_params, torch.bfloat16)
        out = mlp(mlp_params, x, dropout_rate=self.dropout_rate, train=train,
                  generator=self._dropout_gen, final_activation=False).float()
        return l2_normalize(out) if self.norm_embed else out

    def user_tower(self, params, users, train=False, sparse_rows=None,
                   dense_rows=None):
        """``sparse_rows``/``dense_rows``: optional (B, F) overrides of the
        stored user feature rows (request-time features)."""
        return self._tower(params, "user", users, train, sparse_rows, dense_rows)

    def item_tower(self, params, items, train=False, sparse_rows=None):
        return self._tower(params, "item", items, train, sparse_rows, None)

    # ------------------------------------------------------------- training
    def loss_fn(self, params, batch):
        users, items, weight = batch["user"], batch["item"], batch["weight"]
        tree = self._tree(params)
        u = self.user_tower(tree, users, train=True)
        if self.loss_type == "softmax":
            v = self.item_tower(tree, items, train=True)
            loss = softmax_cross_entropy_loss(
                u, v, weight=weight, item_ids=items,
                correction_probs=self.item_probs[items] if self.use_correction else None,
                temperature=self.temperature,
                remove_accidental_hits=self.remove_accidental_hits,
            )
            if self.ssl_pattern is not None:
                loss = loss + self.ssl_alpha * self._ssl_term(tree, items)
            return loss
        neg = batch["item_neg"]                                  # (B, S)
        S = neg.shape[1]
        v_pos = self.item_tower(tree, items, train=True)
        v_neg = self.item_tower(tree, neg.reshape(-1), train=True)
        pos_scores = torch.sum(u * v_pos, dim=1)
        neg_scores = torch.sum(u.repeat_interleave(S, dim=0) * v_neg, dim=1)
        if self.loss_type == "max_margin":
            return max_margin_loss(pos_scores.repeat_interleave(S), neg_scores,
                                   weight.repeat_interleave(S), margin=self.margin)
        logits = torch.cat([pos_scores, neg_scores])
        labels = torch.cat([torch.ones_like(pos_scores), torch.zeros_like(neg_scores)])
        return bce_loss(logits, labels, torch.cat([weight, weight.repeat_interleave(S)]))

    def _ssl_masks(self, F):
        """(in_view1, in_view2): (F,) bool, the item fields each view masks
        to their OOV index. rfm: two random halves; rfm-complementary: a
        random half and the rest; cfm: a random seed field and the half of
        the fields most informative of it, and the rest."""
        half = F // 2 if F > 1 else 1
        gen = self._dropout_gen
        in_view1 = torch.zeros(F, dtype=torch.bool, device=self.device)
        if self.ssl_pattern == "cfm":
            # a tensor index: no read-back to the host
            seed_field = torch.randint(0, F, (), generator=gen, device=self.device)
            in_view1[self.cfm_order[seed_field][:half]] = True
            in_view1[seed_field] = True
        else:
            in_view1[torch.randperm(F, generator=gen, device=self.device)[:half]] = True
        if self.ssl_pattern == "rfm":
            in_view2 = torch.zeros(F, dtype=torch.bool, device=self.device)
            in_view2[torch.randperm(F, generator=gen, device=self.device)[:half]] = True
        else:
            in_view2 = ~in_view1
        return in_view1, in_view2

    def _ssl_term(self, params, items):
        """The contrastive loss between two masked item-feature views."""
        idx = self.feats.item_sparse[items]                      # (B, F)
        in_view1, in_view2 = self._ssl_masks(idx.shape[1])
        oov = self.item_field_oov[None, :]
        view1 = torch.where(in_view1[None, :], oov, idx)
        view2 = torch.where(in_view2[None, :], oov, idx)
        v1 = self.item_tower(params, items, train=True, sparse_rows=view1)
        v2 = self.item_tower(params, items, train=True, sparse_rows=view2)
        return ssl_loss(v1, v2, temperature=self.ssl_temperature)

    # ----------------------------------------------------------- embeddings
    @torch.no_grad()
    def _batched_tower(self, tower, tree, n):
        parts = []
        for start in range(0, n, _TOWER_CHUNK):
            ids = torch.arange(start, min(start + _TOWER_CHUNK, n), device=self.device)
            parts.append(tower(tree, ids))
        return torch.cat(parts).cpu().numpy()

    def set_embeddings(self):
        tree = self._tree()
        self._set_exported(
            self._append_oov(self._batched_tower(self.user_tower, tree, self.n_users)),
            self._append_oov(self._batched_tower(self.item_tower, tree, self.n_items)),
        )

    @torch.no_grad()
    def dyn_user_embedding(self, user, user_feats=None, inner_id=False):
        """A user's embedding with request-time feature overrides; the stored
        tables are not changed."""
        uid = (int(user) if inner_id
               else self.data_info.user2id.get(user, self.n_users))
        users = torch.full((1,), uid, dtype=torch.int64, device=self.device)
        kw = {}
        if user_feats:
            if self.feats.user_sparse is not None:
                row = self.feats.build_user_sparse_row(uid, user_feats)
                kw["sparse_rows"] = torch.as_tensor(
                    row, dtype=torch.int64, device=self.device)[None, :]
            if self.feats.user_dense is not None:
                row = self.feats.build_user_dense_row(uid, user_feats)
                kw["dense_rows"] = torch.as_tensor(
                    row, dtype=torch.float32, device=self.device)[None, :]
        return self.user_tower(self._tree(), users, **kw).cpu().numpy()[0]

    def recommend_user(self, user, n_rec, inner_id=False, cold_start="average",
                       filter_consumed=True, random_rec=False, user_feats=None):
        """``EmbedBase.recommend_user``; with request-time ``user_feats`` the
        user vector goes through the tower again and is ranked against the
        exported item embeddings."""
        if user_feats is None:
            return super().recommend_user(
                user, n_rec, inner_id=inner_id, cold_start=cold_start,
                filter_consumed=filter_consumed, random_rec=random_rec)
        if cold_start not in ("average", "popular"):
            raise ValueError(f"Unknown cold start strategy: {cold_start}")
        users = np.atleast_1d(np.asarray(user))

        def _uid(u):
            if inner_id:
                return int(u) if 0 <= int(u) < self.n_users else -1
            return self.data_info.user2id.get(u, -1)

        raw_uids = np.asarray([_uid(u) for u in users], np.int64)
        # an unknown user: "popular" skips the tower, "average" goes through
        # the OOV row with the request's features
        popular_mask = (raw_uids < 0) & (cold_start == "popular")
        uids = np.where(raw_uids < 0, self.n_users, raw_uids)
        result = {}
        main_idx = np.nonzero(~popular_mask)[0]
        if main_idx.size > 0:
            m_uids = uids[main_idx]
            vecs = np.stack([self.dyn_user_embedding(int(uid), user_feats, inner_id=True)
                             for uid in m_uids])
            scores = torch.from_numpy(vecs).to(self.device) @ self.item_embeds[:-1].T
            if random_rec:
                ids = rank_recommendations(
                    self.task, m_uids, scores.cpu().numpy(), n_rec, self.n_items,
                    self.user_consumed, filter_consumed=filter_consumed,
                    random_rec=True, np_rng=self.data_info.np_rng)
            else:
                consumed = (pad_consumed(self.user_consumed, m_uids, n_rec=int(n_rec),
                                         n_items=self.n_items)
                            if filter_consumed else None)
                ids, _ = topk_from_scores(scores, consumed, int(n_rec))
                ids = ids.cpu().numpy()
            for row, i in enumerate(main_idx):
                result[_key(users[i])] = ids[row]
        for i in np.nonzero(popular_mask)[0]:
            result[_key(users[i])] = popular_recommendations(
                self.data_info, inner_id=True, n_rec=n_rec)
        return self.finalize_rec(result, users, inner_id)


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)
