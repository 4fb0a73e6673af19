"""Base for models whose user embedding is computed from the behavior
sequence (RNN4Rec, Caser, WaveNet).

Counterpart of ``librecommender_tpu/bases/dyn_embed_base.py``. Training rows
carry the history before their position (``batch/sequence.py``); after a fit
every user's embedding is computed from its recent history (a device-resident
table) and exported like any ``EmbedBase`` model's, so ``predict`` and
``recommend_user`` are dot products and the streaming top-k. The row of the
unknown user (id ``n_users``) is the model's forward on an empty history,
not a mean of trained rows. ``recommend_user(seq=...)`` embeds a history
given with the request for one user.

A subclass gives ``_init_params`` and ``_user_repr(params, users, seq,
train)``: (B,) users and (B, L) right-aligned histories padded with
``pad_id == n_items`` -> (B, D) user representations.
"""
import numpy as np
import torch

from .embed_base import EmbedBase, pointwise_rows
from ..batch.sequence import build_train_seqs, get_recent_seqs
from ..ops.losses import bpr_loss, max_margin_loss, pointwise_loss
from ..ops.topk import topk_from_embeddings
from ..utils.validate import check_seq_mode

_EMBED_CHUNK = 1024
LOSS_TYPES = ("cross_entropy", "focal", "bpr", "max_margin", "nce",
              "sampled_softmax")


class DynEmbedBase(EmbedBase):
    def __init__(
        self,
        task,
        data_info,
        loss_type,
        embed_size,
        norm_embed=False,
        recent_num=10,
        random_num=None,
        lower_upper_bound=None,
        seed=42,
        device=None,
    ):
        super().__init__(task, data_info, embed_size, lower_upper_bound, seed,
                         device)
        if loss_type not in LOSS_TYPES:
            raise ValueError(f"unknown loss_type: {loss_type}")
        self.loss_type = loss_type
        self.norm_embed = norm_embed
        self.seq_mode, self.max_seq_len = check_seq_mode(recent_num, random_num)
        self.recent_seq_table = None   # (n_users + 1, L) on the device
        self._dropout_gen = None
        if loss_type in ("bpr", "max_margin"):
            self.paradigm = "pairwise"

    @property
    def pad_id(self):
        return self.n_items

    # ------------------------------------------------------------- contract
    def _user_repr(self, params, users, seq, train):
        """(B,) users + (B, L) histories -> (B, D) user representations;
        ``params`` is the nested tree."""
        raise NotImplementedError

    def _item_repr(self, params):
        """The item output table (rows >= n_items) used for scoring."""
        return params["item_embed"]

    def _item_bias(self, params):
        return params.get("item_bias")

    # ------------------------------------------------------------- training
    def build_model_shell(self):
        """Each user's recent history on the device, and the dropout
        generator."""
        seqs, _ = get_recent_seqs(
            self.n_users, self.user_consumed, self.n_items, self.max_seq_len)
        self.recent_seq_table = torch.from_numpy(seqs).to(self.device)
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(self.seed)

    def batch_extras(self, train_data):
        seqs, _ = build_train_seqs(
            np.asarray(train_data.user_indices),
            np.asarray(train_data.item_indices),
            self.n_items,
            self.max_seq_len,
            mode=self.seq_mode,
            seed=self.seed,
        )
        return {"seq": seqs}

    def _scores_from_repr(self, params, user_repr, items):
        scores = torch.sum(user_repr * self._item_repr(params)[items], dim=-1)
        bias = self._item_bias(params)
        return scores if bias is None else scores + bias[items]

    def loss_fn(self, params, batch):
        users, items, weight = batch["user"], batch["item"], batch["weight"]
        tree = self._tree(params)
        user_repr = self._user_repr(tree, users, batch["seq"], True)
        if self.paradigm == "pairwise":
            neg = batch["item_neg"]                              # (B, S)
            S = neg.shape[1]
            pos_scores = self._scores_from_repr(tree, user_repr, items)
            neg_scores = torch.einsum("bd,bsd->bs", user_repr,
                                      self._item_repr(tree)[neg])
            bias = self._item_bias(tree)
            if bias is not None:
                neg_scores = neg_scores + bias[neg]
            pair_loss = bpr_loss if self.loss_type == "bpr" else max_margin_loss
            return pair_loss(
                pos_scores[:, None].expand(-1, S).reshape(-1),
                neg_scores.reshape(-1),
                weight[:, None].expand(-1, S).reshape(-1),
            )
        _, items, labels, weight = pointwise_rows(batch)
        if "item_neg" in batch:
            S = batch["item_neg"].shape[1]
            user_repr = torch.cat([user_repr, user_repr.repeat_interleave(S, dim=0)])
        logits = self._scores_from_repr(tree, user_repr, items)
        return pointwise_loss(self.task, self.loss_type)(logits, labels, weight)

    def _normed(self, out):
        if not self.norm_embed:
            return out
        return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-8)

    # ----------------------------------------------------------- embeddings
    def _sync_feature_tables(self):
        """Rebuild the device's feature tables and the exported embeddings
        after ``DataInfo.assign_*_features`` moved ``feature_version``, for
        a model that holds feature tables (``self.feats``)."""
        feats = getattr(self, "feats", None)
        version = getattr(self.data_info, "feature_version", 0)
        if feats is not None and feats.version != version:
            from ..ops.features import FeatureTables

            self.feats = FeatureTables(self.data_info, self.device)
            self.set_embeddings()

    @torch.no_grad()
    def _embed_users(self, users, seqs):
        return self._user_repr(self._tree(), users, seqs, False)

    def dyn_user_embedding(self, user, seq=None, inner_id=False):
        """One user's embedding (D,) from ``seq`` (raw item ids, or inner
        ones with ``inner_id``) or, without it, from its stored history."""
        self._sync_feature_tables()
        uid = self._to_inner_user(user, inner_id)
        if seq is not None:
            seq_t = torch.from_numpy(self._convert_seq(seq, inner_id)).to(self.device)
        else:
            seq_t = self.recent_seq_table[uid]
        users = torch.full((1,), uid, dtype=torch.int64, device=self.device)
        return self._embed_users(users, seq_t[None]).cpu().numpy()[0]

    def _to_inner_user(self, user, inner_id):
        if inner_id:
            return int(user) if 0 <= int(user) < self.n_users else self.n_users
        return self.data_info.user2id.get(user, self.n_users)

    def _convert_seq(self, seq, inner_id):
        """Raw item list -> right-aligned padded inner-id array (L,); unknown
        items are dropped."""
        L = self.max_seq_len
        if inner_id:
            ids = [int(i) for i in seq if 0 <= int(i) < self.n_items]
        else:
            ids = [self.data_info.item2id[i] for i in seq
                   if i in self.data_info.item2id]
        ids = ids[-L:]
        out = np.full(L, self.pad_id, np.int64)
        if ids:
            out[L - len(ids):] = ids
        return out

    def set_embeddings(self):
        """Every user's embedding from its recent history, the unknown
        user's (id ``n_users``, an empty history) last; the item table with
        the bias folded into a last column."""
        parts = []
        n = self.n_users + 1
        for start in range(0, n, _EMBED_CHUNK):
            users = torch.arange(start, min(start + _EMBED_CHUNK, n),
                                 device=self.device)
            parts.append(self._embed_users(users, self.recent_seq_table[users]))
        user_repr = torch.cat(parts).cpu().numpy()               # (n_users+1, D)
        tree = self._tree()
        item_repr = self._item_repr(tree).detach()[: self.n_items].cpu().numpy()
        bias = self._item_bias(tree)
        if bias is not None:
            user_repr = np.hstack([user_repr,
                                   np.ones((len(user_repr), 1), np.float32)])
            item_repr = np.hstack([item_repr,
                                   bias.detach()[: self.n_items, None].cpu().numpy()])
        self._set_exported(user_repr.astype(np.float32), self._append_oov(item_repr))

    # ------------------------------------------------------------- inference
    def recommend_user(
        self,
        user,
        n_rec,
        inner_id=False,
        cold_start="average",
        filter_consumed=True,
        random_rec=False,
        seq=None,
        user_feats=None,
    ):
        """As ``EmbedBase.recommend_user``; with ``seq`` (one user only) the
        user's embedding comes from that history, through the top-k.
        ``user_feats`` is accepted and unused, as in the JAX package."""
        self._sync_feature_tables()
        if seq is None:
            return super().recommend_user(user, n_rec, inner_id, cold_start,
                                          filter_consumed, random_rec)
        users = np.atleast_1d(np.asarray(user))
        if len(users) != 1:
            raise ValueError("`seq` recommendation takes one user")
        embed = self.dyn_user_embedding(users[0], seq=seq, inner_id=inner_id)
        if self.item_embeds_np.shape[1] == embed.shape[0] + 1:
            embed = np.concatenate([embed, np.ones(1, np.float32)])
        uid = self._to_inner_user(users[0], inner_id)
        ids, _ = topk_from_embeddings(
            torch.from_numpy(embed).to(self.device),
            self.item_embeds[:-1],
            n_rec,
            user_consumed=self.user_consumed if filter_consumed else None,
            user_ids=[uid],
            filter_consumed=filter_consumed,
        )
        key = users[0].item() if isinstance(users[0], np.generic) else users[0]
        return self.finalize_rec({key: ids[0]}, users, inner_id)
