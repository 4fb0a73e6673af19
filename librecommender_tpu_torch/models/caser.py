"""Caser: convolutional sequence embedding.

Counterpart of ``librecommender_tpu/models/caser.py``, with the same
constructor kwargs and parameter tree: over the masked (B, L, D) history,
L horizontal convolutions of heights 1..L (``nh_filters`` each, relu, a max
over time), one vertical combination across time per embedding dimension
(an einsum with ``v_weight`` (L, nv_filters)), and the user's own embedding,
concatenated and projected to the user embedding. ``dropout_rate`` and
``use_bn`` are accepted and unused, as in the JAX package.
"""
import torch
import torch.nn.functional as F

from ..bases.dyn_embed_base import DynEmbedBase
from ..ops.initializers import truncated_normal
from ..ops.nn import conv1d, dense, init_conv1d, init_dense
from ..utils.misc import aligned_rows


class Caser(DynEmbedBase):
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
        use_bn=False,
        dropout_rate=None,
        nh_filters=2,
        nv_filters=4,
        reg=None,
        batch_size=256,
        sampler="random",
        num_neg=1,
        recent_num=10,
        random_num=None,
        norm_embed=False,
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
            task, data_info, loss_type, embed_size, norm_embed,
            recent_num, random_num, lower_upper_bound, seed, device,
        )
        self.nh_filters = nh_filters  # filters per horizontal height
        self.nv_filters = nv_filters
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        self.reg = reg
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_neg = num_neg

    def _init_params(self, generator):
        D, L = self.embed_size, self.max_seq_len
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        params = {
            "user_embed": truncated_normal(generator, (u_rows, D)),
            "item_embed_in": truncated_normal(generator, (i_rows, D)),
            "item_embed": truncated_normal(generator, (i_rows, D)),
            "item_bias": torch.zeros((i_rows,), device=self.device),
            "h_convs": [init_conv1d(generator, h + 1, D, self.nh_filters)
                        for h in range(L)],
            "v_weight": truncated_normal(generator, (L, self.nv_filters)),
        }
        fc_in = L * self.nh_filters + self.nv_filters * D + D
        params["proj"] = init_dense(generator, fc_in, D)
        return params

    def _user_repr(self, params, users, seq, train):
        embeds = params["item_embed_in"][seq]                    # (B, L, D)
        embeds = embeds * (seq != self.pad_id).to(embeds.dtype)[:, :, None]
        h_cat = torch.cat(
            [F.relu(conv1d(conv, embeds)).amax(dim=1)            # (B, nh)
             for conv in params["h_convs"]], dim=1)
        v_out = torch.einsum("bld,lf->bfd", embeds, params["v_weight"])
        out = dense(params["proj"], torch.cat(
            [h_cat, v_out.reshape(v_out.shape[0], -1), params["user_embed"][users]],
            dim=1))
        return self._normed(out)
