"""BPR: Bayesian Personalized Ranking matrix factorization.

Counterpart of ``librecommender_tpu/models/bpr.py``, with the same
constructor kwargs and parameter layout: tables padded to ``aligned_rows``
rows, the item bias folded into column D of the item table, and exported
user rows with a ones column so that a score is one dot product. Ranking
task only. A training step looks up the user, positive and negative rows
through ``table_lookup``, so on the GPU through the gather kernel and, for
the gradients, the segment-sum kernel: three launches of each a step.
"""
import functools

import numpy as np
import torch
from torch import nn

from ..bases.embed_base import EmbedBase
from ..convert import bpr_params_from_jax, bpr_params_to_jax
from ..ops.initializers import truncated_normal
from ..ops.losses import bpr_loss
from ..ops.table_gather import table_lookup
from ..utils.misc import aligned_rows


class BPR(EmbedBase):
    paradigm = "pairwise"

    def __init__(
        self,
        task,
        data_info,
        loss_type="bpr",
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
        use_tf=None,  # accepted for API familiarity; ignored
        optimizer="adam",
        num_threads=1,  # accepted for API familiarity (Cython-path knob); ignored
        sparse_optimizer=None,
        mxu_gather="auto",
        seed=42,
        lower_upper_bound=None,  # accepted for API familiarity (ranking-only)
        device=None,
    ):
        # `device` stays out of all_args: the JAX package loads the saved
        # hyper-params as kwargs and has no such argument
        self.all_args = {
            k: v
            for k, v in locals().items()
            if k not in ("self", "__class__", "data_info", "device")
        }
        if task != "ranking":
            raise ValueError("BPR is only suitable for ranking")
        super().__init__(task, data_info, embed_size, None, seed, device)
        if loss_type != "bpr":
            raise ValueError("BPR uses bpr loss")
        self.loss_type = loss_type
        # l2-normalize latent factors (bias column excluded) in the exported
        # embeddings (reference libreco/algorithms/bpr.py:196,390)
        self.norm_embed = norm_embed
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        self.reg = reg
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_neg = num_neg
        if optimizer not in ("adam", "sgd", "momentum"):
            raise ValueError("optimizer must be one of ('adam', 'sgd', 'momentum')")
        if optimizer != "adam" and sparse_optimizer:
            raise ValueError("sparse_optimizer (LazyAdam) requires optimizer='adam'")
        self.optimizer = optimizer
        # lazy Adam is the default on the adam path, as in the JAX package
        if sparse_optimizer is None:
            sparse_optimizer = optimizer == "adam"
        self.sparse_optimizer = sparse_optimizer
        self.sparse_tables = ("user_embed", "item_embed")
        # "auto", "rows" or "dense": which lazy-Adam form updates the tables
        self.sparse_update_mode = "auto"
        # "auto"/True: table lookups through TableGather (the kernels on the
        # GPU); False: plain indexing
        self.mxu_gather = mxu_gather

    def _custom_optimizer(self):
        if self.optimizer == "adam":
            return None  # the trainer's Adam (lr_decay-aware)
        momentum = 0.9 if self.optimizer == "momentum" else 0.0
        return functools.partial(torch.optim.SGD, lr=self.lr, momentum=momentum)

    def touched_indices(self, batch):
        items = batch["item"]
        if "item_neg" in batch:
            items = torch.cat([items, batch["item_neg"].reshape(-1)])
        return {"user_embed": batch["user"], "item_embed": items}

    def loss_fn(self, params, batch):
        users, items_pos, weight = batch["user"], batch["item"], batch["weight"]
        items_neg = batch["item_neg"]                            # (B, S)
        D = self.embed_size
        use_kernel = self.mxu_gather is not False
        ue = table_lookup(params["user_embed"], users, use_kernel)  # (B, D)
        pe = table_lookup(params["item_embed"], items_pos, use_kernel)
        ne = table_lookup(params["item_embed"], items_neg, use_kernel)
        if self.norm_embed:
            def _norm(x):
                return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
            ue = _norm(ue)
            pe = torch.cat([_norm(pe[:, :D]), pe[:, D:]], dim=-1)
            ne = torch.cat([_norm(ne[..., :D]), ne[..., D:]], dim=-1)
        ua = torch.cat([ue, torch.ones_like(ue[:, :1])], dim=1)
        pos_scores = (ua * pe).sum(dim=-1)
        neg_scores = (ua[:, None, :] * ne).sum(dim=-1)           # (B, S)
        S = items_neg.shape[1]
        loss = bpr_loss(
            pos_scores[:, None].expand(-1, S).reshape(-1),
            neg_scores.reshape(-1),
            weight[:, None].expand(-1, S).reshape(-1),
        )
        if self.reg:
            # the latent factors only (bias column excluded), summed over
            # every row of the batch, padded ones included, as in JAX
            loss = loss + self.reg * (
                torch.square(ue).sum()
                + torch.square(pe[:, :D]).sum()
                + torch.square(ne[..., :D]).sum()
            ) / users.shape[0]
        return loss

    def build_model(self):
        """Random tables from the seed: truncated normal factors, zero item
        bias in column D."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        user = truncated_normal(gen, (u_rows, self.embed_size))
        item = torch.cat(
            [truncated_normal(gen, (i_rows, self.embed_size)),
             torch.zeros((i_rows, 1), device=self.device)], dim=1,
        )
        self.net = nn.ParameterDict(
            {"user_embed": nn.Parameter(user), "item_embed": nn.Parameter(item)}
        )

    def params_from_arrays(self, params):
        self.net = nn.ParameterDict({
            k: nn.Parameter(v)
            for k, v in bpr_params_from_jax(params, self.device).items()
        })

    def params_to_arrays(self):
        return bpr_params_to_jax(self.net)

    def set_embeddings(self):
        p = self.params_to_arrays()
        n_u, n_i = self.n_users, self.n_items
        ue = np.asarray(p["user_embed"][:n_u])
        item = np.array(p["item_embed"][:n_i])  # bias already in col D
        if self.norm_embed:
            ue = ue / np.maximum(np.linalg.norm(ue, axis=-1, keepdims=True), 1e-12)
            fac = item[:, : self.embed_size]
            item[:, : self.embed_size] = fac / np.maximum(
                np.linalg.norm(fac, axis=-1, keepdims=True), 1e-12
            )
        user = np.hstack([ue, np.ones((n_u, 1), np.float32)])
        self._set_exported(self._append_oov(user), self._append_oov(item))
