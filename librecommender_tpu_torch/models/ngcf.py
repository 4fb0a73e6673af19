"""NGCF: neural graph collaborative filtering.

Counterpart of ``librecommender_tpu/models/ngcf.py``, with the same
constructor kwargs and parameter tree (``w1``/``w2``/``b1``/``b2`` lists, one
entry a layer). The Laplacian is the row-normalised (A + I), kept as the raw
binary interactions ``R`` (dense, or an edge list) and ``1 / (deg + 1)``: a
layer's ``side = (R @ other + self) / (deg + 1)``, then
``leaky_relu(side @ w1 + b1 + (side * h) @ w2 + b2, 0.2)``, message dropout
and an L2 normalisation; the normalised output feeds the next layer, and all
layers (the raw embeddings first) are concatenated, so the exported width is
``embed_size * (1 + len(hidden_units))`` when the hidden units equal the
embedding size. The dense products with ``R`` are float32 whatever the
caller's TF32 setting; the edge form sums with ``index_add``. Node dropout
(on R's entries) and message dropout draw from the model's generator.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..bases.graph_base import GraphEmbedBase
from ..graph.adjacency import build_edges
from ..ops.initializers import truncated_normal
from ..ops.nn import float32_matmul, l2_normalize
from ..utils.misc import aligned_rows


class NGCF(GraphEmbedBase):
    def __init__(
        self,
        task,
        data_info,
        loss_type="bpr",
        embed_size=16,
        n_epochs=20,
        lr=0.001,
        lr_decay=False,
        epsilon=1e-8,
        reg=None,
        batch_size=256,
        sampler="random",
        num_neg=1,
        margin=1.0,
        amsgrad=False,
        lower_upper_bound=None,
        hidden_units=(64, 64, 64),
        node_dropout=0.0,
        message_dropout=0.0,
        dense_adj_limit=200_000_000,
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
            raise ValueError("NGCF is only suitable for ranking")
        super().__init__(task, data_info, loss_type, embed_size, None, seed,
                         device)
        self.margin = margin
        self.amsgrad = amsgrad
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        self.reg = reg
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_neg = num_neg
        self.hidden_units = tuple(hidden_units)
        self.node_dropout = node_dropout
        self.message_dropout = message_dropout
        self.dense_adj_limit = dense_adj_limit
        self.edge_u = self.edge_i = self.edge_w = None
        self.adj = None

    def _build_graph(self):
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        eu, ei, _ = build_edges(self.data_info.user_consumed, self.n_users,
                                self.n_items)
        deg_u = np.zeros(u_rows, np.float32)
        deg_i = np.zeros(i_rows, np.float32)
        np.add.at(deg_u, eu, 1.0)
        np.add.at(deg_i, ei, 1.0)
        self.inv_du = torch.from_numpy(1.0 / (deg_u + 1.0)).to(self.device)
        self.inv_di = torch.from_numpy(1.0 / (deg_i + 1.0)).to(self.device)
        self.adj = self.edge_u = self.edge_i = self.edge_w = None
        if u_rows * i_rows <= self.dense_adj_limit:
            R = torch.zeros((u_rows, i_rows), dtype=torch.float32)
            R[torch.from_numpy(eu).long(), torch.from_numpy(ei).long()] = 1.0
            self.adj = R.to(self.device)
        else:
            self.edge_u = torch.from_numpy(eu.astype(np.int64)).to(self.device)
            self.edge_i = torch.from_numpy(ei.astype(np.int64)).to(self.device)
            self.edge_w = torch.ones(len(eu), device=self.device)

    def _init_params(self, generator):
        dims = [self.embed_size, *self.hidden_units]
        params = {
            "user_embed": truncated_normal(
                generator, (aligned_rows(self.n_users), self.embed_size)),
            "item_embed": truncated_normal(
                generator, (aligned_rows(self.n_items), self.embed_size)),
            "w1": [], "w2": [], "b1": [], "b2": [],
        }
        for li in range(len(self.hidden_units)):
            scale = dims[li] ** -0.5
            for key in ("w1", "w2"):
                params[key].append(truncated_normal(
                    generator, (dims[li], dims[li + 1]), scale=scale))
            for key in ("b1", "b2"):
                params[key].append(torch.zeros(dims[li + 1], device=self.device))
        return params

    def _propagate(self, params, train):
        user_h, item_h = params["user_embed"], params["item_embed"]
        u_rows, i_rows = user_h.shape[0], item_h.shape[0]
        user_layers, item_layers = [user_h], [item_h]
        keep = 1.0 - self.node_dropout
        node_drop = train and self.node_dropout > 0.0
        if self.adj is not None:
            A = self.adj
            if node_drop:
                A = torch.where(self._keep_mask(A.shape, keep), A / keep, 0.0)
        else:
            w = self.edge_w
            if node_drop:
                w = torch.where(self._keep_mask(w.shape, keep), w / keep, 0.0)
            eu, ei = self.edge_u, self.edge_i
        inv_du, inv_di = self.inv_du[:, None], self.inv_di[:, None]
        for w1, b1, w2, b2 in zip(params["w1"], params["b1"], params["w2"],
                                  params["b2"]):
            if self.adj is not None:
                side_u = inv_du * (float32_matmul(A, item_h) + user_h)
                side_i = inv_di * (float32_matmul(A.T, user_h) + item_h)
            else:
                agg_u = user_h.new_zeros(u_rows, item_h.shape[1]).index_add(
                    0, eu, item_h[ei] * w[:, None])
                agg_i = item_h.new_zeros(i_rows, user_h.shape[1]).index_add(
                    0, ei, user_h[eu] * w[:, None])
                side_u = inv_du * (agg_u + user_h)
                side_i = inv_di * (agg_i + item_h)
            u_new = F.leaky_relu(side_u @ w1 + b1 + (side_u * user_h) @ w2 + b2,
                                 negative_slope=0.2)
            i_new = F.leaky_relu(side_i @ w1 + b1 + (side_i * item_h) @ w2 + b2,
                                 negative_slope=0.2)
            if train and self.message_dropout > 0.0:
                m_keep = 1.0 - self.message_dropout
                u_new = torch.where(self._keep_mask(u_new.shape, m_keep),
                                    u_new / m_keep, 0.0)
                i_new = torch.where(self._keep_mask(i_new.shape, m_keep),
                                    i_new / m_keep, 0.0)
            user_h, item_h = l2_normalize(u_new), l2_normalize(i_new)
            user_layers.append(user_h)
            item_layers.append(item_h)
        return torch.cat(user_layers, dim=1), torch.cat(item_layers, dim=1)
