"""AutoInt: feature interactions by multi-head self-attention over fields.

Counterpart of ``librecommender_tpu/models/autoint.py``, with the same
constructor kwargs and parameter tree: stacked interacting layers
(self-attention over the field axis, a residual and a projection), then a
linear head over the flattened fields. ``dropout_rate`` is accepted and
unused, as in the JAX package.
"""
import torch.nn.functional as F

from ..bases.feat_base import FeatBase
from ..ops.initializers import truncated_normal
from ..ops.nn import dense, init_dense, init_mha, mha
from ..utils.misc import aligned_rows


class AutoInt(FeatBase):
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
        att_embed_size=(8, 8, 8),
        num_heads=2,
        use_residual=True,
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
        self.att_layer_dims = tuple(d * num_heads for d in att_embed_size)
        self.num_heads = num_heads
        self.use_residual = use_residual

    def _init_params(self, generator):
        D = self.embed_size
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        params = {
            "user_embed": truncated_normal(generator, (u_rows, D)),
            "item_embed": truncated_normal(generator, (i_rows, D)),
        }
        if self.feats.has_sparse:
            params["sparse_embed"] = truncated_normal(
                generator, (self._sparse_rows(), D))
        if self.feats.has_dense:
            params["dense_embed"] = truncated_normal(
                generator, (self.feats.n_dense_fields, D))
        layers = []
        dim_in = D
        for dim_out in self.att_layer_dims:
            layers.append({
                "mha": init_mha(generator, dim_in, self.num_heads,
                                dim_out // self.num_heads),
                # mha projects back to dim_in through wo; re-project to dim_out
                "proj": init_dense(generator, dim_in, dim_out),
            })
            dim_in = dim_out
        params["att_layers"] = layers
        params["head"] = init_dense(generator, self.n_fields * dim_in, 1)
        return params

    def _forward(self, params, inputs, train):
        x, _, _ = self._field_embeds(params, inputs)           # (B, F, D)
        B, n_fields = x.shape[0], x.shape[1]
        for layer in params["att_layers"]:
            att = mha(layer["mha"], x, x, num_heads=self.num_heads)
            # residual and projection on flat (B * F, dim) tokens
            flat = att.reshape(B * n_fields, -1)
            if self.use_residual:
                flat = flat + x.reshape(B * n_fields, -1)
            x = F.relu(dense(layer["proj"], flat)).reshape(B, n_fields, -1)
        return dense(params["head"], x.reshape(B, -1))[:, 0]
