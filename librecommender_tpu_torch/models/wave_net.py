"""WaveNet: dilated causal convolutions over the behavior sequence.

Counterpart of ``librecommender_tpu/models/wave_net.py``, with the same
constructor kwargs and parameter tree: ``n_blocks`` blocks of
``n_layers_per_block`` causal convolutions of width 2 (dilations 1, 2,
4, ... within a block, relu), a final width-1 convolution (relu), a global
max-pool over time projected to ``embed_size``, and the user's static
embedding before it: the user side is 2 * D wide, so the item tables are
too. ``dropout_rate`` and ``use_bn`` are accepted and unused, as in the JAX
package.
"""
import torch
import torch.nn.functional as F

from ..bases.dyn_embed_base import DynEmbedBase
from ..ops.initializers import truncated_normal
from ..ops.nn import causal_conv1d, dense, init_conv1d, init_dense
from ..utils.misc import aligned_rows


class WaveNet(DynEmbedBase):
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
        n_blocks=1,
        n_layers_per_block=4,
        use_bn=False,
        dropout_rate=None,
        n_filters=16,
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
        self.n_blocks = n_blocks
        self.n_layers_per_block = n_layers_per_block
        self.n_filters = n_filters
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        self.reg = reg
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_neg = num_neg

    def _init_params(self, generator):
        D, F_ = self.embed_size, self.n_filters
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        n_convs = self.n_blocks * self.n_layers_per_block
        return {
            "item_embed_in": truncated_normal(generator, (i_rows, D)),
            "user_embed": truncated_normal(generator, (u_rows, D)),
            "item_embed": truncated_normal(generator, (i_rows, 2 * D)),
            "item_bias": torch.zeros((i_rows,), device=self.device),
            "convs": [init_conv1d(generator, 2, D if i == 0 else F_, F_)
                      for i in range(n_convs)],
            "final_conv": init_conv1d(generator, 1, F_, F_),
            "proj": init_dense(generator, F_, D),
        }

    def _user_repr(self, params, users, seq, train):
        x = params["item_embed_in"][seq]                         # (B, L, D)
        for i, conv in enumerate(params["convs"]):
            dilation = 2 ** (i % self.n_layers_per_block)
            x = F.relu(causal_conv1d(conv, x, dilation=dilation))
        x = F.relu(causal_conv1d(params["final_conv"], x))
        conv_out = dense(params["proj"], x.amax(dim=1))          # global max-pool
        return self._normed(torch.cat([params["user_embed"][users], conv_out], dim=1))
