"""Wide & Deep, with FTRL on the wide part and Adam on the deep part.

Counterpart of ``librecommender_tpu/models/wide_deep.py``, with the same
constructor kwargs and parameter tree: the wide part is the first-order
linear term (the ``linear_*`` parameters), trained with FTRL-Proximal at
``lr["wide"]``; the deep part, an MLP over the field embeddings, and the
embeddings themselves train with Adam at ``lr["deep"]``. ``lr_decay`` has no
effect on this pair of optimizers, as in the JAX package.
"""
import torch

from ..bases.feat_base import FeatBase
from ..ops.initializers import truncated_normal
from ..ops.nn import dense, init_dense, init_mlp, mlp
from ..training.optimizers import Ftrl, OptimizerChain
from ..utils.misc import aligned_rows


class WideDeep(FeatBase):
    def __init__(
        self,
        task,
        data_info,
        loss_type="cross_entropy",
        embed_size=16,
        n_epochs=20,
        lr=None,
        lr_decay=False,
        epsilon=1e-5,
        reg=None,
        batch_size=256,
        sampler="random",
        num_neg=1,
        use_bn=True,
        dropout_rate=None,
        hidden_units=(128, 64, 32),
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
        lr = lr if lr is not None else {"wide": 0.01, "deep": 1e-4}
        if not isinstance(lr, dict) or "wide" not in lr or "deep" not in lr:
            raise ValueError("`lr` for WideDeep must be dict {'wide': v, 'deep': v}")
        super().__init__(
            task, data_info, loss_type, embed_size, n_epochs, lr, lr_decay,
            epsilon, reg, batch_size, sampler, num_neg, seed,
            lower_upper_bound, multi_sparse_combiner, device,
        )
        self.hidden_units = tuple(hidden_units)
        self.use_bn = use_bn
        self.dropout_rate = dropout_rate or 0.0

    def _init_params(self, generator):
        D = self.embed_size
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        params = {
            "user_embed": truncated_normal(generator, (u_rows, D)),
            "item_embed": truncated_normal(generator, (i_rows, D)),
        }
        params.update(self._init_linear(u_rows, i_rows))
        if self.feats.has_sparse:
            params["sparse_embed"] = truncated_normal(
                generator, (self._sparse_rows(), D))
        if self.feats.has_dense:
            params["dense_embed"] = truncated_normal(
                generator, (self.feats.n_dense_fields, D))
        params["deep_mlp"] = init_mlp(generator, self.n_fields * D,
                                      list(self.hidden_units), use_ln=self.use_bn)
        params["deep_out"] = init_dense(generator, self.hidden_units[-1], 1)
        return params

    def _forward(self, params, inputs, train):
        embeds, sparse_idx, dense_vals = self._field_embeds(params, inputs)
        wide = self._linear_term(params, inputs["user"], inputs["item"],
                                 sparse_idx, dense_vals)
        h = mlp(params["deep_mlp"], embeds.reshape(embeds.shape[0], -1),
                dropout_rate=self.dropout_rate, train=train,
                generator=self._dropout_gen)
        return wide + dense(params["deep_out"], h)[:, 0]

    def _custom_optimizer(self):
        """FTRL on the wide (``linear_*``) parameters, Adam on the rest: a
        factory of the parameters the trainer hands it, which it sorts by
        their names in ``self.net``."""

        def make(params):
            wide_ids = {id(p) for key, p in self.net.items()
                        if key.startswith("linear_")}
            wide = [p for p in params if id(p) in wide_ids]
            deep = [p for p in params if id(p) not in wide_ids]
            return OptimizerChain(
                Ftrl(wide, lr=self.lr["wide"]),
                torch.optim.Adam(deep, lr=self.lr["deep"], eps=self.epsilon),
            )

        return make
