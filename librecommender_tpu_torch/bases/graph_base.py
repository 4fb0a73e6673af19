"""Base for full-graph GNN embedding models (LightGCN, NGCF, GraphSage,
PinSage).

Counterpart of ``librecommender_tpu/bases/graph_base.py``: a model's
``_propagate(params, train)`` computes the full (user_out, item_out)
matrices every step from its graph (built beside the parameters by
``_build_graph``), and the loss indexes them per batch.

- user-to-item (``graph_paradigm == "u2i"``): pointwise (with or without
  sampled negatives) or pairwise (``bpr``, ``max_margin`` with the model's
  ``margin``), plus ``reg`` times the squared looked-up embeddings over the
  batch;
- item-to-item (``"i2i"``): a batch only sets how many start nodes a step
  walks from; walk pairs and their negatives are drawn on the device
  (``graph/walks.py``), and a user's exported embedding is the mean of their
  consumed items' final embeddings.

Node features (GraphSage, PinSage): a node's level-0 representation is the
projected concatenation of its field embeddings and its id embedding
(``_init_node_feats``, ``_node_base``); the i2i user side is not projected.
The exported tables are one propagation in eval mode. Batch, neighbour and
sparse-feature lookups go through ``_lookup``: plain indexing, or, while
``_mxu_lookup`` is set (GraphSage and PinSage declare it, and the trainer
sets it for a fit on the GPU), the gather and segment-sum kernels. Draws
come from the model's generators through seams a test can replace:
``_keep_mask`` (dropout), ``_start_nodes``, ``_walk_slots`` and
``_neg_proposals`` (i2i). The graph family's Adam epsilon defaults to 1e-8,
as in the JAX package.
"""
import numpy as np
import torch

from .embed_base import EmbedBase
from .feat_base import LOOKUP_MAX_ROWS
from ..ops.features import FeatureTables
from ..ops.initializers import truncated_normal
from ..ops.losses import bce_loss, bpr_loss, focal_loss, max_margin_loss, mse_loss
from ..ops.nn import dense, init_dense
from ..ops.table_gather import table_lookup


class GraphEmbedBase(EmbedBase):
    graph_paradigm = "u2i"

    def __init__(
        self,
        task,
        data_info,
        loss_type,
        embed_size,
        lower_upper_bound=None,
        seed=42,
        device=None,
    ):
        super().__init__(task, data_info, embed_size, lower_upper_bound, seed,
                         device)
        if loss_type not in ("cross_entropy", "focal", "bpr", "max_margin"):
            raise ValueError(f"unknown loss_type for graph model: {loss_type}")
        self.loss_type = loss_type
        if loss_type in ("bpr", "max_margin"):
            self.paradigm = "pairwise"
        self._dropout_gen = None
        self.feats = None

    # ------------------------------------------------------------- contract
    def _build_graph(self):
        """The graph's device tensors, from ``data_info.user_consumed``."""
        raise NotImplementedError

    def _propagate(self, params, train):
        """Nested ``params`` -> (user_out (u_rows, D'), item_out (i_rows, D'))."""
        raise NotImplementedError

    def build_model_shell(self):
        self._build_graph()
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(self.seed)

    def _keep_mask(self, shape, keep):
        """A Bernoulli(keep) bool mask of ``shape`` from the model's
        generator."""
        return torch.rand(shape, generator=self._dropout_gen,
                          device=self.device) < keep

    def _lookup(self, table, ids):
        """``table[ids]``, through the gather kernel (its gradient the
        segment-sum kernel) while ``_mxu_lookup`` is set and the table passes
        ``LOOKUP_MAX_ROWS``."""
        use = getattr(self, "_mxu_lookup", False)
        return table_lookup(table, ids, use and table.shape[0] <= LOOKUP_MAX_ROWS)

    def _margin_loss(self, pos, neg, w):
        return max_margin_loss(pos, neg, w, margin=getattr(self, "margin", 1.0))

    # -------------------------------------------------------- node features
    def _init_node_feats(self, generator, params):
        """Add the field embeddings and the projections of ``[field embeds,
        id embed]`` to ``params`` when the data has features (a user
        projection in u2i only)."""
        f, D = self.feats, self.embed_size
        if f is None:
            return params
        if f.has_sparse:
            params["sparse_embed"] = truncated_normal(generator, (f.sparse_vocab, D))
        if f.has_dense:
            params["dense_embed"] = truncated_normal(generator, (f.n_dense_fields, D))
        fu = 1 + len(f.user_sparse_pos) + len(f.user_dense_pos)
        fi = 1 + len(f.item_sparse_pos) + len(f.item_dense_pos)
        if self.graph_paradigm == "u2i":
            params["user_feat_proj"] = init_dense(generator, fu * D, D)
        params["item_feat_proj"] = init_dense(generator, fi * D, D)
        return params

    def _build_feats(self):
        """The device feature tables when the data has features, else None."""
        di = self.data_info
        has = bool(len(di.sparse_col.name) or len(di.dense_col.name))
        self.feats = FeatureTables(di, self.device) if has else None

    def _node_base(self, params, which):
        """(aligned rows, D) level-0 node representations: the id embedding
        without features (or on the unprojected i2i user side), else the
        projected concatenation of field embeddings and id embedding, zero
        below the real rows."""
        base = params["user_embed" if which == "user" else "item_embed"]
        proj_key = "user_feat_proj" if which == "user" else "item_feat_proj"
        f = self.feats
        if f is None or proj_key not in params:
            return base
        n = self.n_users if which == "user" else self.n_items
        parts = []
        tab = f.user_sparse if which == "user" else f.item_sparse
        if f.has_sparse and tab is not None:
            parts.append(self._lookup(params["sparse_embed"], tab[:n]).reshape(n, -1))
        vals = f.user_dense if which == "user" else f.item_dense
        pos = f.user_dense_pos if which == "user" else f.item_dense_pos
        if f.has_dense and vals is not None and pos:
            dvec = params["dense_embed"][torch.as_tensor(pos, device=self.device)]
            parts.append((vals[:n, :, None] * dvec[None]).reshape(n, -1))
        parts.append(base[:n])
        out = dense(params[proj_key], torch.cat(parts, dim=1))
        return torch.cat([out, out.new_zeros(base.shape[0] - n, out.shape[1])])

    # ------------------------------------------------------------- training
    def loss_fn(self, params, batch):
        if self.graph_paradigm == "i2i":
            return self._i2i_loss(params, batch)
        users, items, labels, weight = (
            batch["user"], batch["item"], batch["label"], batch["weight"],
        )
        user_out, item_out = self._propagate(self._tree(params), True)
        u = self._lookup(user_out, users)
        if self.paradigm == "pairwise":
            neg = batch["item_neg"]                              # (B, S)
            S = neg.shape[1]
            pos_items = self._lookup(item_out, items)
            neg_items = self._lookup(item_out, neg)
            pos_scores = torch.sum(u * pos_items, dim=1)
            neg_scores = torch.einsum("bd,bsd->bs", u, neg_items)
            pair_loss = bpr_loss if self.loss_type == "bpr" else self._margin_loss
            loss = pair_loss(
                pos_scores[:, None].expand(-1, S).reshape(-1),
                neg_scores.reshape(-1),
                weight[:, None].expand(-1, S).reshape(-1),
            )
            reg_embeds = (u, pos_items, neg_items)
        else:
            if "item_neg" in batch:
                neg = batch["item_neg"]
                S = neg.shape[1]
                u_all = torch.cat([u, u.repeat_interleave(S, dim=0)])
                i_all = torch.cat([self._lookup(item_out, items),
                                   self._lookup(item_out, neg.reshape(-1))])
                labels_all = torch.cat(
                    [torch.ones_like(labels), labels.new_zeros(neg.numel())])
                weight_all = torch.cat([weight, weight.repeat_interleave(S)])
            else:
                u_all, i_all, labels_all, weight_all = (
                    u, self._lookup(item_out, items), labels, weight)
            logits = torch.sum(u_all * i_all, dim=1)
            if self.task == "rating":
                point_loss = mse_loss
            else:
                point_loss = bce_loss if self.loss_type == "cross_entropy" else focal_loss
            loss = point_loss(logits, labels_all, weight_all)
            reg_embeds = (u_all, i_all)
        if getattr(self, "reg", None):
            loss = loss + self.reg * sum(
                torch.sum(torch.square(e)) for e in reg_embeds) / users.shape[0]
        return loss

    # the i2i draws, each from the model's walk generator
    def _start_nodes(self, b):
        """(b,) start items: uniform, or under ``start_node="unpopular"`` by
        the subsampling keep-probabilities."""
        if self.start_node == "unpopular":
            return torch.multinomial(self._start_probs, b, replacement=True,
                                     generator=self._walk_gen)
        return torch.randint(0, self.n_items, (b,), generator=self._walk_gen,
                             device=self.device)

    def _walk_slots(self, shape, high):
        """Slots uniform in [0, high): a walk hop's, or training's neighbour
        picks."""
        return torch.randint(0, high, shape, generator=self._walk_gen,
                             device=self.device)

    def _neg_proposals(self, shape):
        """One round of negative proposals: rows of the batch's pairs
        (``sampler="out-batch"``), items by popularity (``"popular"``) or
        uniform items."""
        if self.sampler == "out-batch":
            return torch.randint(0, shape[0], shape, generator=self._walk_gen,
                                 device=self.device)
        if self.sampler == "popular":
            n = shape[0] * shape[1]
            return torch.multinomial(self._neg_probs, n, replacement=True,
                                     generator=self._walk_gen).reshape(shape)
        return torch.randint(0, self.n_items, shape, generator=self._walk_gen,
                             device=self.device)

    def _i2i_loss(self, params, batch):
        """Item-to-item training: ``num_walks * sample_walk_len`` walk pairs
        from each of the batch's start nodes, negatives excluding anchor and
        positive, each pair weighted by its start row's weight and its
        validity."""
        from ..graph.walks import i2i_negatives, walk_pairs

        weight = batch["weight"]
        start = self._start_nodes(weight.shape[0])
        anchors, positives, valid = walk_pairs(
            start, self.item_nbr, self.item_deg, self.user_nbr, self.user_deg,
            self.num_walks, self.sample_walk_len, self.focus_start,
            self._walk_slots)
        w = weight.repeat_interleave(self.num_walks * self.sample_walk_len) * valid
        neg = i2i_negatives(anchors, positives, self.num_neg, self._neg_proposals,
                            out_batch=self.sampler == "out-batch")
        _, item_out = self._propagate(self._tree(params), True)
        a = self._lookup(item_out, anchors)
        p = self._lookup(item_out, positives)
        n = self._lookup(item_out, neg)                          # (P, S, D)
        s = self.num_neg
        pos_scores = torch.sum(a * p, dim=1)
        neg_scores = torch.einsum("pd,psd->ps", a, n)
        if self.loss_type in ("bpr", "max_margin"):
            pair_loss = bpr_loss if self.loss_type == "bpr" else self._margin_loss
            loss = pair_loss(
                pos_scores[:, None].expand(-1, s).reshape(-1),
                neg_scores.reshape(-1),
                w[:, None].expand(-1, s).reshape(-1),
            )
        else:
            logits = torch.cat([pos_scores, neg_scores.reshape(-1)])
            labels = torch.cat([torch.ones_like(pos_scores),
                                pos_scores.new_zeros(neg_scores.numel())])
            w_all = torch.cat([w, w[:, None].expand(-1, s).reshape(-1)])
            point_loss = bce_loss if self.loss_type == "cross_entropy" else focal_loss
            loss = point_loss(logits, labels, w_all)
        if getattr(self, "reg", None):
            loss = loss + self.reg * sum(
                torch.sum(torch.square(e)) for e in (a, p, n)) / anchors.shape[0]
        return loss

    # ----------------------------------------------------------- embeddings
    @torch.no_grad()
    def set_embeddings(self):
        user_out, item_out = self._propagate(self._tree(), False)
        item_np = item_out[: self.n_items].cpu().numpy()
        if self.graph_paradigm == "i2i":
            # i2i trains no user tower: a user is the mean of their consumed
            # items' final embeddings
            user_np = np.zeros((self.n_users, item_np.shape[1]), item_np.dtype)
            counts = np.zeros(self.n_users, dtype=item_np.dtype)
            uc = self.data_info.user_consumed
            idx_u = np.concatenate([np.full(len(v), int(u)) for u, v in uc.items()])
            idx_i = np.concatenate([np.asarray(v) for v in uc.values()])
            np.add.at(user_np, idx_u, item_np[idx_i])
            np.add.at(counts, idx_u, 1.0)
            user_np /= np.maximum(counts, 1.0)[:, None]
        else:
            user_np = user_out[: self.n_users].cpu().numpy()
        self._set_exported(self._append_oov(user_np), self._append_oov(item_np))
