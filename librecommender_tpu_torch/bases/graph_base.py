"""Base for full-graph GNN embedding models, the user-to-item path (LightGCN,
NGCF).

Counterpart of the u2i path of ``librecommender_tpu/bases/graph_base.py``:
a model's ``_propagate(params, train)`` computes the full (user_out,
item_out) matrices every step from its graph (built beside the parameters by
``_build_graph``), and the loss indexes them per batch: pointwise (with or
without sampled negatives) or pairwise (``bpr``, ``max_margin`` with the
model's ``margin``), plus ``reg`` times the squared looked-up embeddings
over the batch. The exported tables are one propagation in eval mode.
Dropout masks draw from the model's generator through ``_keep_mask``.

The item-to-item path (GraphSage, PinSage: walks, node features) comes with
GraphSage's slice (1.11); a model whose ``graph_paradigm`` is ``"i2i"``
raises. The graph family's Adam epsilon defaults to 1e-8, as in the JAX
package.
"""
import torch

from .embed_base import EmbedBase
from ..ops.losses import bce_loss, bpr_loss, focal_loss, max_margin_loss, mse_loss


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
        if self.graph_paradigm != "u2i":
            raise NotImplementedError(
                "the item-to-item graph path (walks, node features) comes with "
                "GraphSage's slice (1.11)"
            )
        super().__init__(task, data_info, embed_size, lower_upper_bound, seed,
                         device)
        if loss_type not in ("cross_entropy", "focal", "bpr", "max_margin"):
            raise ValueError(f"unknown loss_type for graph model: {loss_type}")
        self.loss_type = loss_type
        if loss_type in ("bpr", "max_margin"):
            self.paradigm = "pairwise"
        self._dropout_gen = None

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

    def _margin_loss(self, pos, neg, w):
        return max_margin_loss(pos, neg, w, margin=getattr(self, "margin", 1.0))

    # ------------------------------------------------------------- training
    def loss_fn(self, params, batch):
        users, items, labels, weight = (
            batch["user"], batch["item"], batch["label"], batch["weight"],
        )
        user_out, item_out = self._propagate(self._tree(params), True)
        u = user_out[users]
        if self.paradigm == "pairwise":
            neg = batch["item_neg"]                              # (B, S)
            S = neg.shape[1]
            pos_items, neg_items = item_out[items], item_out[neg]
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
                i_all = torch.cat([item_out[items], item_out[neg.reshape(-1)]])
                labels_all = torch.cat(
                    [torch.ones_like(labels), labels.new_zeros(neg.numel())])
                weight_all = torch.cat([weight, weight.repeat_interleave(S)])
            else:
                u_all, i_all, labels_all, weight_all = (
                    u, item_out[items], labels, weight)
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

    # ----------------------------------------------------------- embeddings
    @torch.no_grad()
    def set_embeddings(self):
        user_out, item_out = self._propagate(self._tree(), False)
        self._set_exported(
            self._append_oov(user_out[: self.n_users].cpu().numpy()),
            self._append_oov(item_out[: self.n_items].cpu().numpy()),
        )
