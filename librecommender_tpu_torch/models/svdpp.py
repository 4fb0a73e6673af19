"""SVD++: biased matrix factorization with implicit-feedback item factors.

Counterpart of ``librecommender_tpu/models/svdpp.py``, with the same
constructor kwargs and parameter tree. A user is represented by
``u + |N(u)|^-1/2 * sum_{j in N(u)} y_j`` over its consumed items (the last
``recent_num`` of them, at most ``max_implicit``), in one of two forms built
from the same neighbour table, so they agree:

- a dense (u_rows, i_rows) matrix ``W`` of entries ``1/sqrt(|N(u)|)`` on the
  device and one ``W @ implicit_embed`` a step (``torch.matmul``), while
  ``u_rows * i_rows <= dense_adj_limit``;
- beyond it, the padded neighbour table gathered a batch at a time with a
  masked mean.
"""
import numpy as np
import torch

from ..bases.embed_base import EmbedBase, pointwise_rows
from ..graph.adjacency import build_neighbor_table
from ..ops.initializers import truncated_normal
from ..ops.losses import pointwise_loss
from ..utils.misc import aligned_rows

_EMBED_CHUNK = 1024


class SVDpp(EmbedBase):
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
        recent_num=None,
        max_implicit=128,
        dense_adj_limit=200_000_000,
        seed=42,
        lower_upper_bound=None,
        device=None,
    ):
        # `device` stays out of all_args: the JAX package loads the saved
        # hyper-params as kwargs and has no such argument
        self.all_args = {
            k: v for k, v in locals().items()
            if k not in ("self", "__class__", "data_info", "device")
        }
        super().__init__(task, data_info, embed_size, lower_upper_bound, seed,
                         device)
        if loss_type not in ("cross_entropy", "focal"):
            raise ValueError(f"SVDpp takes cross_entropy or focal loss, got "
                             f"{loss_type!r}")
        if recent_num is not None and (
                not isinstance(recent_num, int) or recent_num <= 0):
            raise ValueError("`recent_num` must be None or positive int")
        self.loss_type = loss_type
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        self.reg = reg
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_neg = num_neg
        # each user's `recent_num` most recent consumed items make the
        # implicit term; None keeps all, up to the `max_implicit` table width
        self.recent_num = recent_num
        self.max_implicit = (max_implicit if recent_num is None
                             else min(max_implicit, recent_num))
        self.dense_adj_limit = dense_adj_limit
        self.implicit_adj = None      # (u_rows, i_rows) W, the dense form
        self.consumed_table = None    # (n_users, C) neighbours, the gather form
        self.consumed_counts = None   # (n_users,)

    def build_model_shell(self):
        """The implicit term's neighbour table, as ``W`` on the device or as
        the padded table and its counts."""
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        consumed = self.data_info.user_consumed
        if self.recent_num is not None:
            consumed = {u: list(items)[-self.recent_num:]
                        for u, items in consumed.items()}
        table, counts = build_neighbor_table(
            consumed, self.n_users, self.max_implicit, pad=self.n_items)
        self.implicit_adj = self.consumed_table = self.consumed_counts = None
        if u_rows * i_rows <= self.dense_adj_limit:
            valid = np.arange(table.shape[1])[None, :] < counts[:, None]
            rows = np.nonzero(valid)[0]
            vals = (1.0 / np.sqrt(counts[rows].astype(np.float64))).astype(np.float32)
            W = torch.zeros((u_rows, i_rows), device=self.device)
            W[torch.from_numpy(rows).to(self.device),
              torch.from_numpy(table[valid].astype(np.int64)).to(self.device)] = \
                torch.from_numpy(vals).to(self.device)
            self.implicit_adj = W
        else:
            self.consumed_table = torch.from_numpy(table).to(self.device)
            self.consumed_counts = torch.from_numpy(counts).to(self.device)

    def _init_params(self, generator):
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        D = self.embed_size
        return {
            "user_embed": truncated_normal(generator, (u_rows, D)),
            "item_embed": truncated_normal(generator, (i_rows, D)),
            "implicit_embed": truncated_normal(generator, (i_rows, D)),
            "user_bias": torch.zeros((u_rows,), device=self.device),
            "item_bias": torch.zeros((i_rows,), device=self.device),
        }

    def _user_repr(self, params, users):
        if self.implicit_adj is not None:
            implicit_all = self.implicit_adj @ params["implicit_embed"]
            return params["user_embed"][users] + implicit_all[users]
        nbrs = self.consumed_table[users]                        # (B, C)
        mask = (nbrs != self.n_items).to(torch.float32)
        y = params["implicit_embed"][nbrs]                       # (B, C, D)
        implicit = torch.sum(y * mask[:, :, None], dim=1)
        counts = self.consumed_counts[users].clamp_min(1.0)
        implicit = implicit / torch.sqrt(counts)[:, None]
        return params["user_embed"][users] + implicit

    def loss_fn(self, params, batch):
        users, items = batch["user"], batch["item"]
        point_loss = pointwise_loss(self.task, self.loss_type)
        u = self._user_repr(params, users)                       # once a row
        scores = (params["user_bias"][users] + params["item_bias"][items]
                  + torch.sum(u * params["item_embed"][items], dim=-1))
        if "item_neg" in batch:
            neg = batch["item_neg"]
            negs = (params["user_bias"][users][:, None] + params["item_bias"][neg]
                    + torch.einsum("bd,bsd->bs", u, params["item_embed"][neg]))
            scores = torch.cat([scores, negs.reshape(-1)])
        _, _, labels, weight = pointwise_rows(batch)
        loss = point_loss(scores, labels, weight)
        if self.reg:
            loss = loss + self.reg * (
                torch.sum(torch.square(params["user_embed"][users]))
                + torch.sum(torch.square(params["item_embed"][items]))
            ) / users.shape[0]
        return loss

    @torch.no_grad()
    def set_embeddings(self):
        parts = []
        for start in range(0, self.n_users, _EMBED_CHUNK):
            users = torch.arange(start, min(start + _EMBED_CHUNK, self.n_users),
                                 device=self.device)
            parts.append(self._user_repr(self.net, users).cpu().numpy())
        u_repr = (np.concatenate(parts) if parts
                  else np.zeros((0, self.embed_size), np.float32))
        p = self.params_to_arrays()
        n_u, n_i = self.n_users, self.n_items
        user = np.hstack([u_repr, p["user_bias"][:n_u, None],
                          np.ones((n_u, 1), np.float32)])
        item = np.hstack([p["item_embed"][:n_i], np.ones((n_i, 1), np.float32),
                          p["item_bias"][:n_i, None]])
        self._set_exported(self._append_oov(user), self._append_oov(item))
