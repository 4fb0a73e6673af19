"""SVD: biased matrix factorization.

Counterpart of ``librecommender_tpu/models/svd.py``, with the same
constructor kwargs and parameter tree: score = user_bias + item_bias +
<u, v>, the biases 1-D tables; the exported embeddings fold the biases into
two extra columns, so a recommendation stays one dot product. Lookups are
plain indexing, as in the JAX package.

With ``sparse_optimizer`` the four tables take the lazy Adam of
``training/sparse_optim.py``. Its dense form marks a row touched where its
gradient has a non-zero entry along the last axis, so a 1-D bias table is
one row to it: once any bias moves, every bias takes an Adam step. The JAX
package does the same, and the port keeps it.
"""
import numpy as np
import torch

from ..bases.embed_base import EmbedBase, pointwise_rows
from ..ops.initializers import truncated_normal
from ..ops.losses import pointwise_loss
from ..ops.nn import l2_normalize
from ..utils.misc import aligned_rows


def normalize_rows_np(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


class SVD(EmbedBase):
    paradigm = "pointwise"

    def __init__(
        self,
        task,
        data_info,
        loss_type="cross_entropy",
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
        sparse_optimizer=False,
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
            raise ValueError(f"SVD takes cross_entropy or focal loss, got "
                             f"{loss_type!r}")
        self.loss_type = loss_type
        # l2-normalized latent factors in the score and the exported tables
        self.norm_embed = norm_embed
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        self.reg = reg
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_neg = num_neg
        self.sparse_optimizer = sparse_optimizer
        self.sparse_tables = ("user_embed", "item_embed", "user_bias", "item_bias")
        # "auto", "rows" or "dense": which lazy-Adam form updates the tables
        self.sparse_update_mode = "auto"

    def touched_indices(self, batch):
        items = batch["item"]
        if "item_neg" in batch:
            items = torch.cat([items, batch["item_neg"].reshape(-1)])
        users = batch["user"]
        return {"user_embed": users, "item_embed": items,
                "user_bias": users, "item_bias": items}

    def _init_params(self, generator):
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        return {
            "user_embed": truncated_normal(generator, (u_rows, self.embed_size)),
            "item_embed": truncated_normal(generator, (i_rows, self.embed_size)),
            "user_bias": torch.zeros((u_rows,), device=self.device),
            "item_bias": torch.zeros((i_rows,), device=self.device),
        }

    def _scores(self, params, users, items):
        ue = params["user_embed"][users]
        ie = params["item_embed"][items]
        if self.norm_embed:
            ue, ie = l2_normalize(ue, eps=1e-12), l2_normalize(ie, eps=1e-12)
        return (params["user_bias"][users] + params["item_bias"][items]
                + torch.sum(ue * ie, dim=-1))

    def loss_fn(self, params, batch):
        users, items, labels, weight = pointwise_rows(batch)
        point_loss = pointwise_loss(self.task, self.loss_type)
        loss = point_loss(self._scores(params, users, items), labels, weight)
        if self.reg:
            loss = loss + self.reg * (
                torch.sum(torch.square(params["user_embed"][users]))
                + torch.sum(torch.square(params["item_embed"][items]))
            ) / users.shape[0]
        return loss

    def set_embeddings(self):
        p = self.params_to_arrays()
        n_u, n_i = self.n_users, self.n_items
        pu, qi = p["user_embed"][:n_u], p["item_embed"][:n_i]
        if self.norm_embed:
            pu, qi = normalize_rows_np(pu), normalize_rows_np(qi)
        user = np.hstack([pu, p["user_bias"][:n_u, None],
                          np.ones((n_u, 1), np.float32)])
        item = np.hstack([qi, np.ones((n_i, 1), np.float32),
                          p["item_bias"][:n_i, None]])
        self._set_exported(self._append_oov(user), self._append_oov(item))
