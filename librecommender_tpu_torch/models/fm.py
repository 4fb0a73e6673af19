"""FM: factorization machine with a pairwise-interaction head.

Counterpart of ``librecommender_tpu/models/fm.py``, with the same
constructor kwargs and parameter tree: a first-order linear term over every
feature plus the second-order pairwise-interaction vector
0.5 * ((sum_f v_f)^2 - sum_f v_f^2), layer-normed (``use_bn``), dropped out in
training and projected by a linear head.
"""
from ..bases.feat_base import FeatBase
from ..ops.initializers import truncated_normal
from ..ops.nn import dropout, init_layer_norm, layer_norm
from ..utils.misc import aligned_rows


class FM(FeatBase):
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
        use_bn=True,
        dropout_rate=None,
        multi_sparse_combiner="sqrtn",
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
        super().__init__(
            task, data_info, loss_type, embed_size, n_epochs, lr, lr_decay,
            epsilon, reg, batch_size, sampler, num_neg, seed,
            lower_upper_bound, multi_sparse_combiner, device,
        )
        self.use_bn = use_bn
        self.dropout_rate = dropout_rate or 0.0

    def _init_params(self, generator):
        D = self.embed_size
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        params = {
            "user_embed": truncated_normal(generator, (u_rows, D)),
            "item_embed": truncated_normal(generator, (i_rows, D)),
            "pair_head": truncated_normal(generator, (D,), scale=D ** -0.5),
        }
        if self.use_bn:
            params["pair_ln"] = init_layer_norm(D, self.device)
        params.update(self._init_linear(u_rows, i_rows))
        if self.feats.has_sparse:
            params["sparse_embed"] = truncated_normal(
                generator, (self._sparse_rows(), D))
        if self.feats.has_dense:
            params["dense_embed"] = truncated_normal(
                generator, (self.feats.n_dense_fields, D))
        return params

    def _forward(self, params, inputs, train):
        embeds, sparse_idx, dense_vals = self._field_embeds(params, inputs)
        linear = self._linear_term(params, inputs["user"], inputs["item"],
                                   sparse_idx, dense_vals)
        pairwise = pairwise_interaction(embeds)                  # (B, D)
        if self.use_bn:
            pairwise = layer_norm(params["pair_ln"], pairwise)
        if train and self.dropout_rate > 0.0:
            pairwise = dropout(pairwise, self.dropout_rate, self._dropout_gen)
        return linear + pairwise @ params["pair_head"]


def pairwise_interaction(embeds):
    """(B, F, D) field embeddings -> (B, D) sum of their pairwise products,
    0.5 * ((sum_f v_f)^2 - sum_f v_f^2)."""
    sum_sq = embeds.sum(dim=1).square()
    sq_sum = embeds.square().sum(dim=1)
    return 0.5 * (sum_sq - sq_sum)
