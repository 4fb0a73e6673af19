"""NCF: neural collaborative filtering (GMF and MLP branches).

Counterpart of ``librecommender_tpu/models/ncf.py``, with the same
constructor kwargs and parameter tree: one embedding table per side feeds
both branches (gmf = u * v; the MLP over [u, v]), and a linear head over
[gmf, MLP(u, v)] gives the logit. An id-only model (no feature fields, plain
indexing of its tables) scored by a full forward pass, hence ``FeatBase``.
"""
import torch

from ..bases.feat_base import FeatBase
from ..ops.initializers import truncated_normal
from ..ops.nn import dense, init_dense, init_mlp, mlp
from ..utils.misc import aligned_rows


class NCF(FeatBase):
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
        hidden_units=(128, 64, 32),
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
            lower_upper_bound, device=device,
        )
        self.hidden_units = tuple(hidden_units)
        self.use_bn = use_bn
        self.dropout_rate = dropout_rate or 0.0

    def _init_params(self, generator):
        D = self.embed_size
        u_rows, i_rows = aligned_rows(self.n_users), aligned_rows(self.n_items)
        return {
            # one shared table per side feeds both branches
            "user_embed": truncated_normal(generator, (u_rows, D)),
            "item_embed": truncated_normal(generator, (i_rows, D)),
            "mlp": init_mlp(generator, 2 * D, list(self.hidden_units),
                            use_ln=self.use_bn),
            "head": init_dense(generator, D + self.hidden_units[-1], 1),
        }

    def _forward(self, params, inputs, train):
        ue = params["user_embed"][inputs["user"]]
        ie = params["item_embed"][inputs["item"]]
        h = mlp(params["mlp"], torch.cat([ue, ie], dim=1),
                dropout_rate=self.dropout_rate, train=train,
                generator=self._dropout_gen)
        return dense(params["head"], torch.cat([ue * ie, h], dim=1))[:, 0]
