"""BPR: Bayesian Personalized Ranking matrix factorization (serving half).

Counterpart of ``librecommender_tpu/models/bpr.py``, with the same
constructor kwargs and parameter layout: tables padded to ``aligned_rows``
rows, the item bias folded into column D of the item table, and exported
user rows with a ones column so that a score is one dot product. Ranking
task only. Training comes with the training slice of the port.
"""
import numpy as np
import torch
from torch import nn

from ..bases.embed_base import EmbedBase
from ..convert import bpr_params_from_jax, bpr_params_to_jax
from ..ops.initializers import truncated_normal

# Table rows are rounded up to this multiple (the JAX package's ROW_ALIGN),
# so saved parameters have the same shapes in both packages.
ROW_ALIGN = 8


def aligned_rows(n_ids):
    """Table rows for ``n_ids`` real ids + 1 OOV row, aligned to ROW_ALIGN."""
    return -(-(n_ids + 1) // ROW_ALIGN) * ROW_ALIGN


class BPR(EmbedBase):
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
        mxu_gather="auto",  # kept for the saved format; a TPU option, ignored
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
        if sparse_optimizer is None:
            sparse_optimizer = optimizer == "adam"
        self.sparse_optimizer = sparse_optimizer

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
