"""DIN: Deep Interest Network, target attention over behavior history.

Counterpart of ``librecommender_tpu/models/din.py``, with the same
constructor kwargs and parameter tree: per history position, an MLP over
[key, query, key-query, key*query] produces attention logits
(``din_attention``); masked softmax weights pool the history. With
``pallas_grad_scatter=True`` (an attribute, as in the JAX package) the
gradient of the history's and the targets' token gathers runs through the
row scatter-add kernel on the GPU.
"""
import warnings

import torch

from ..bases.seq_base import SeqFeatBase
from ..ops.initializers import truncated_normal
from ..ops.nn import (
    dense,
    din_attention,
    init_dense,
    init_din_attention,
    init_mlp,
    mlp,
)
from ..utils.misc import aligned_rows


class DIN(SeqFeatBase):
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
        recent_num=10,
        random_num=None,
        use_tf_attention=False,  # accepted for API familiarity (TF-impl switch); ignored
        feat_agg_mode=None,
        multi_sparse_combiner="sqrtn",
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
        super().__init__(
            task, data_info, loss_type, embed_size, n_epochs, lr, lr_decay,
            epsilon, reg, batch_size, sampler, num_neg, seed,
            lower_upper_bound, multi_sparse_combiner, device,
            recent_num=recent_num, random_num=random_num,
        )
        self.hidden_units = tuple(hidden_units)
        self.use_bn = use_bn
        self.dropout_rate = dropout_rate or 0.0
        self.sparse_optimizer = sparse_optimizer
        # the default keeps bare item tokens; 'concat'/'elementwise' build
        # attention keys/targets from feature-augmented tokens
        if feat_agg_mode not in ("concat", "elementwise", None):
            raise ValueError("`feat_agg_mode` must be `concat`, `elementwise` or None")
        self.feat_agg_mode = feat_agg_mode
        if use_tf_attention:
            warnings.warn(
                "`use_tf_attention=True` is accepted for API familiarity "
                "but has no effect: this DIN always uses the paper-style "
                "attention",
                UserWarning,
                stacklevel=2,
            )

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
        params["att"] = init_din_attention(generator, self.token_dim)
        self._init_token_norms(params)
        in_dim = self.n_fields * D + self.token_dim  # fields + attended history
        params["mlp"] = init_mlp(generator, in_dim, list(self.hidden_units),
                                 use_ln=self.use_bn)
        params["head"] = init_dense(generator, self.hidden_units[-1], 1)
        return params

    shared_seq = True  # pos/neg targets share each row's history (loss_fn)

    def _score_catalog(self, params, users, overrides=None, items=None):
        """Full-catalog scoring with per-user seq work shared across items:
        the catalog is the multi-target axis of din_attention, so the
        history's token gather runs once per user instead of n_items times
        (the generic pair scorer repeats it per item). ``items``: optional
        (T,) item subset; ``overrides``: per-user (U, L) "seq" / (U, F)
        feature rows of a request."""
        if items is None:
            items = torch.arange(self.n_items, device=self.device)
        n_users, n_items = users.shape[0], items.shape[0]
        table = self._token_table(params)
        seq = self._catalog_seq(users, overrides)
        seq_emb = self._token_embeds(params, seq, table)        # (U, L, TD)
        mask = seq != self.pad_id
        target = self._token_embeds(params, items, table)       # (n_items, TD)
        tgt = target[:, None, :].expand(n_items, n_users, target.shape[1])
        att = din_attention(params["att"], tgt, seq_emb, mask)
        att_out = att.transpose(0, 1).reshape(n_users * n_items, att.shape[-1])
        embeds, _, _ = self._field_embeds(
            params, self._catalog_pair_inputs(users, overrides, items))
        x = torch.cat([embeds.reshape(embeds.shape[0], -1), att_out], dim=1)
        h = mlp(params["mlp"], x)
        return dense(params["head"], h)[:, 0].reshape(n_users, n_items)

    def _forward(self, params, inputs, train):
        items = inputs["item"]
        embeds, _, _ = self._field_embeds(params, inputs)
        table = self._token_table(params)
        seq = self._seq_for(inputs)
        seq_emb = self._token_embeds(params, seq, table)        # (B, L, TD)
        mask = seq != self.pad_id
        target = self._token_embeds(params, items, table)       # (TB, TD)
        B = seq.shape[0]
        if target.shape[0] != B:
            # shared-seq training: attend all targets over the row's shared
            # keys in one (T, B, D) call, then restore the row order
            att = din_attention(
                params["att"], self._target_blocks(target, B), seq_emb, mask
            )
            att_out = self._blocks_to_rows(att)
        else:
            att_out = din_attention(params["att"], target, seq_emb, mask)
        x = torch.cat([embeds.reshape(embeds.shape[0], -1), att_out], dim=1)
        h = mlp(params["mlp"], x, dropout_rate=self.dropout_rate, train=train,
                generator=self._dropout_gen)
        return dense(params["head"], h)[:, 0]
