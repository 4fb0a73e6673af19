"""LightGCN: layer-averaged linear propagation over the normalised adjacency.

Counterpart of ``librecommender_tpu/models/lightgcn.py``, with the same
constructor kwargs and parameter tree: K layers e^(k+1) = A_hat e^(k), no
weights and no nonlinearity, the embedding the mean of all layers, edge
dropout in training. Two forms of the propagation:

- dense, where ``u_rows * i_rows <= dense_adj_limit``: two products a layer,
  ``A @ item_h`` and ``A.T @ user_h``, in float32 whatever the caller's TF32
  setting (``ops/nn.float32_matmul``). With ``adj_dtype="bf16"`` A holds
  bfloat16 values and each layer's input is rounded to bfloat16, as the JAX
  package's ``jnp.dot(A_bf16, h.astype(bf16), preferred_element_type=f32)``:
  a product of two bfloat16 values is exact in float32, so a float32 product
  of the rounded operands is that function up to summation order, and the
  messages stay float32. A is kept as float32 holding the bfloat16 values
  (4 bytes an entry, where bfloat16 storage would take 2), so that no pass
  converts it;
- edges: a gather, a weight multiply and a sum into ``u_rows`` / ``i_rows``
  rows (``index_add``, not bit-repeatable on the GPU).
"""
import numpy as np
import torch

from ..bases.graph_base import GraphEmbedBase
from ..graph.adjacency import build_dense_adjacency, build_edges
from ..ops.initializers import truncated_normal
from ..ops.nn import float32_matmul
from ..utils.misc import aligned_rows


class LightGCN(GraphEmbedBase):
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
        n_layers=3,
        dropout_rate=0.0,
        dense_adj_limit=200_000_000,
        adj_dtype="bf16",
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
            raise ValueError("LightGCN is only suitable for ranking")
        super().__init__(task, data_info, loss_type, embed_size, None, seed,
                         device)
        if adj_dtype not in ("bf16", "f32"):
            raise ValueError("adj_dtype must be 'bf16' or 'f32'")
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
        self.n_layers = n_layers
        self.dropout_rate = dropout_rate
        self.dense_adj_limit = dense_adj_limit
        self.adj_dtype = adj_dtype
        self.edge_u = self.edge_i = self.edge_w = None
        self.adj = None  # dense (u_rows, i_rows) when within the limit

    def _build_graph(self):
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        consumed = self.data_info.user_consumed
        self.adj = self.edge_u = self.edge_i = self.edge_w = None
        if u_rows * i_rows <= self.dense_adj_limit:
            adj = torch.from_numpy(build_dense_adjacency(
                consumed, self.n_users, self.n_items, u_rows, i_rows))
            if self.adj_dtype == "bf16":
                adj = adj.to(torch.bfloat16).float()
            self.adj = adj.to(self.device)
        else:
            eu, ei, ew = build_edges(consumed, self.n_users, self.n_items)
            self.edge_u = torch.from_numpy(eu.astype(np.int64)).to(self.device)
            self.edge_i = torch.from_numpy(ei.astype(np.int64)).to(self.device)
            self.edge_w = torch.from_numpy(ew).to(self.device)

    def _init_params(self, generator):
        # scale 0.1: propagation averages shrink the signal
        return {
            "user_embed": truncated_normal(
                generator, (aligned_rows(self.n_users), self.embed_size), scale=0.1),
            "item_embed": truncated_normal(
                generator, (aligned_rows(self.n_items), self.embed_size), scale=0.1),
        }

    def _layer_input(self, h):
        """A dense layer's input as the adjacency's type rounds it."""
        if self.adj_dtype == "bf16":
            return h.to(torch.bfloat16).float()
        return h

    def _propagate(self, params, train):
        user_h, item_h = params["user_embed"], params["item_embed"]
        user_acc, item_acc = user_h, item_h
        dropping = train and self.dropout_rate > 0.0
        keep = 1.0 - self.dropout_rate
        if self.adj is not None:
            A = self.adj
            if dropping:
                scaled = A / keep
                if self.adj_dtype == "bf16":
                    scaled = scaled.to(torch.bfloat16).float()
                A = torch.where(self._keep_mask(A.shape, keep), scaled, 0.0)
            for _ in range(self.n_layers):
                user_h, item_h = (float32_matmul(A, self._layer_input(item_h)),
                                  float32_matmul(A.T, self._layer_input(user_h)))
                user_acc = user_acc + user_h
                item_acc = item_acc + item_h
        else:
            u_rows, i_rows = user_h.shape[0], item_h.shape[0]
            w = self.edge_w
            if dropping:
                w = torch.where(self._keep_mask(w.shape, keep), w / keep, 0.0)
            eu, ei = self.edge_u, self.edge_i
            for _ in range(self.n_layers):
                user_h, item_h = (
                    user_h.new_zeros(u_rows, user_h.shape[1]).index_add(
                        0, eu, item_h[ei] * w[:, None]),
                    item_h.new_zeros(i_rows, item_h.shape[1]).index_add(
                        0, ei, user_h[eu] * w[:, None]),
                )
                user_acc = user_acc + user_h
                item_acc = item_acc + item_h
        scale = 1.0 / (self.n_layers + 1)
        return user_acc * scale, item_acc * scale
