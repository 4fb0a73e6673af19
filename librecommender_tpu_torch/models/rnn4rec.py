"""RNN4Rec (GRU4Rec): a recurrent user state over the behavior sequence.

Counterpart of ``librecommender_tpu/models/rnn4rec.py``, with the same
constructor kwargs and parameter tree: a GRU or LSTM (``ops/nn.py``, loops
of plain tensor ops) over the history's input embeddings, the final state
optionally layer-normed (then tanh), projected to the user embedding; a
score is <user, item_embed> + item_bias. Input dropout draws from the
model's generator. ``bpr`` and ``max_margin`` train pairwise.
"""
import torch

from ..bases.dyn_embed_base import DynEmbedBase
from ..ops.initializers import truncated_normal
from ..ops.nn import (
    dense, dropout, gru, init_dense, init_gru, init_layer_norm, init_lstm,
    layer_norm, lstm,
)
from ..utils.misc import aligned_rows


class RNN4Rec(DynEmbedBase):
    def __init__(
        self,
        task,
        data_info,
        rnn_type="gru",
        loss_type="cross_entropy",
        embed_size=16,
        n_epochs=20,
        lr=0.001,
        lr_decay=False,
        epsilon=1e-5,
        hidden_units=(16,),
        reg=None,
        batch_size=256,
        sampler="random",
        num_neg=1,
        dropout_rate=None,
        use_layer_norm=False,
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
        if rnn_type not in ("gru", "lstm"):
            raise ValueError(f"rnn_type must be gru or lstm, got {rnn_type!r}")
        super().__init__(
            task, data_info, loss_type, embed_size, norm_embed,
            recent_num, random_num, lower_upper_bound, seed, device,
        )
        self.rnn_type = rnn_type
        self.hidden_dim = tuple(hidden_units)[0]
        self.dropout_rate = dropout_rate or 0.0
        self.use_layer_norm = use_layer_norm
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        self.reg = reg
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_neg = num_neg

    def _init_params(self, generator):
        D, H = self.embed_size, self.hidden_dim
        i_rows = aligned_rows(self.n_items)
        init_rnn = init_gru if self.rnn_type == "gru" else init_lstm
        params = {
            "item_embed_in": truncated_normal(generator, (i_rows, D)),
            "rnn": init_rnn(generator, D, H),
            "proj": init_dense(generator, H, D),
            "item_embed": truncated_normal(generator, (i_rows, D)),
            "item_bias": torch.zeros((i_rows,), device=self.device),
        }
        if self.use_layer_norm:
            params["rnn_ln"] = init_layer_norm(H, self.device)
        return params

    def _user_repr(self, params, users, seq, train):
        embeds = params["item_embed_in"][seq]                    # (B, L, D)
        if train and self.dropout_rate > 0.0:
            embeds = dropout(embeds, self.dropout_rate, self._dropout_gen)
        run = gru if self.rnn_type == "gru" else lstm
        h_final, _ = run(params["rnn"], embeds, mask=seq != self.pad_id)
        if self.use_layer_norm:
            h_final = torch.tanh(layer_norm(params["rnn_ln"], h_final))
        return self._normed(dense(params["proj"], h_final))
