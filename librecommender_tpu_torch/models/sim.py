"""SIM: two-stage long-sequence interest modeling (GSU + ESU).

Counterpart of ``librecommender_tpu/models/sim.py``, with the same
constructor kwargs and parameter tree. The General Search Unit soft-searches
the ``search_topk`` items of a ``long_max_len`` history most similar to the
target (by embedding dot product, an exact top-k over the short axis), the
Exact Search Unit runs multi-head attention over them, and a DIN attention
covers the short recent window.

Training optimizes ``alpha * first + beta * second``: the first stage is an
MLP over the sum-pooled long history and the target, the second the
GSU -> ESU, short-window attention and feature-field MLP. Inference
(predict, recommend, serving) scores with the second stage alone. With
``pallas_grad_scatter=True`` the gradients of the token gathers (the
targets, the short window and, with ``long_history_grad``, the long
history's B * long_max_len ids) run through the row scatter-add kernel on
the GPU.
"""
import numpy as np
import torch

from ..bases.seq_base import SeqFeatBase
from ..batch.sequence import build_train_seqs, get_recent_seqs
from ..ops.initializers import truncated_normal
from ..ops.nn import (
    dense,
    din_attention,
    init_dense,
    init_din_attention,
    init_mha,
    init_mlp,
    mha,
    mlp,
)
from ..ops.topk import topk_lastdim_small_onehot
from ..utils.misc import aligned_rows


class SIM(SeqFeatBase):
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
        alpha=1.0,
        beta=1.0,
        recent_num=10,
        random_num=None,
        long_max_len=100,
        short_max_len=None,  # the reference's name for the short window; overrides recent_num
        long_history_grad=True,
        search_topk=10,
        num_heads=2,
        feat_agg_mode=None,
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
            recent_num=recent_num if short_max_len is None else short_max_len,
            random_num=random_num,
        )
        if feat_agg_mode not in ("concat", "elementwise", None):
            raise ValueError("`feat_agg_mode` must be `concat`, `elementwise` or None")
        if search_topk > long_max_len:
            raise ValueError("`search_topk` must be at most `long_max_len`")
        if not (0.0 <= alpha <= 1.0 and 0.0 <= beta <= 1.0):
            raise ValueError("`alpha` and `beta` must lie in [0, 1]")
        self.feat_agg_mode = feat_agg_mode
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.hidden_units = tuple(hidden_units)
        self.use_bn = use_bn
        self.dropout_rate = dropout_rate or 0.0
        self.long_max_len = long_max_len
        self.long_history_grad = bool(long_history_grad)
        self.search_topk = search_topk
        self.num_heads = num_heads
        self.recent_long_table = None  # (n_users + 1, long_max_len) tensor

    def build_model_shell(self):
        super().build_model_shell()
        seqs, _ = get_recent_seqs(
            self.n_users, self.user_consumed, self.n_items, self.long_max_len
        )
        self.recent_long_table = torch.from_numpy(seqs).to(self.device)

    def batch_extras(self, train_data):
        users = np.asarray(train_data.user_indices)
        items = np.asarray(train_data.item_indices)
        short, _ = build_train_seqs(
            users, items, self.n_items, self.max_seq_len,
            mode=self.seq_mode, seed=self.seed,
        )
        long, _ = build_train_seqs(
            users, items, self.n_items, self.long_max_len, seed=self.seed
        )
        return {"seq": short, "seq_long": long}

    def _init_params(self, generator):
        D, TD = self.embed_size, self.token_dim
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
        params["short_att"] = init_din_attention(generator, TD)
        params["esu_mha"] = init_mha(generator, TD, self.num_heads)
        self._init_token_norms(params)
        # first stage: the target and the sum-pooled long history
        params["first_mlp"] = init_mlp(generator, 2 * TD, list(self.hidden_units),
                                       use_ln=self.use_bn)
        params["first_head"] = init_dense(generator, self.hidden_units[-1], 1)
        # second stage: feature fields, ESU and short-window attention
        in_dim = self.n_fields * D + 2 * TD
        params["mlp"] = init_mlp(generator, in_dim, list(self.hidden_units),
                                 use_ln=self.use_bn)
        params["head"] = init_dense(generator, self.hidden_units[-1], 1)
        return params

    def _long_seq_for(self, inputs):
        if "seq_long" in inputs:
            return inputs["seq_long"]
        return self.recent_long_table[inputs["user"]]

    def _request_seq_overrides(self, uids, seq_list, inner_id):
        """Both windows of a request seq: the short one its last
        ``max_seq_len`` items, the long one its last ``long_max_len`` (the
        short window is a suffix of the long one, as in training). Users
        without a request seq keep their stored histories."""
        short_rows, long_rows = [], []
        short_tab = long_tab = None
        for uid, s in zip(uids, seq_list):
            if s is None:
                if short_tab is None:
                    short_tab = self.recent_seq_table.cpu().numpy()
                    long_tab = self.recent_long_table.cpu().numpy()
                short_rows.append(short_tab[int(uid)])
                long_rows.append(long_tab[int(uid)])
            else:
                short_rows.append(self._convert_request_seq(s, inner_id))
                long_rows.append(self._convert_request_seq(
                    s, inner_id, max_len=self.long_max_len))
        return {"seq": np.stack(short_rows).astype(np.int64),
                "seq_long": np.stack(long_rows).astype(np.int64)}

    shared_seq = True  # pos/neg targets share each row's (long) history

    def _second_stage(self, params, tgt, long_emb, long_mask, short_emb,
                      short_mask, want_pool=False):
        """GSU soft search, ESU attention and short-window attention for
        (T, B) target blocks over shared per-row histories; also the whole
        inference output.

        The GSU's top-k comes as a one-hot (``topk_lastdim_small_onehot``),
        so the selection of the long history's rows is one batched product
        (B, T*K, L) x (B, L, D), whose backward is a product too.
        ``want_pool=True`` adds the mask as one more selector row: the same
        product returns the first stage's masked sum-pool of the history."""
        T, B, D = tgt.shape
        K = self.search_topk
        sims = torch.einsum("tbd,bld->tbl", tgt, long_emb)
        sims = torch.where(long_mask[None], sims, float("-inf"))
        top_sims, _, sel_onehot = topk_lastdim_small_onehot(sims, K)  # (T, B, K, L)
        ohm = (sel_onehot.to(long_emb.dtype)
               .permute(1, 0, 2, 3).reshape(B, T * K, -1))
        if want_pool:
            ohm = torch.cat([ohm, long_mask.to(long_emb.dtype)[:, None, :]], dim=1)
        out = torch.bmm(ohm, long_emb)                               # (B, M, D)
        sel_emb = out[:, : T * K].reshape(B, T, K, D).permute(1, 0, 2, 3)
        pooled = out[:, T * K] if want_pool else None                # (B, D)
        sel_mask = torch.isfinite(top_sims)

        # ESU: exact multi-head attention over the selected items
        esu_out = mha(
            params["esu_mha"], tgt.reshape(T * B, 1, D),
            sel_emb.reshape(T * B, K, D),
            mask=sel_mask.reshape(T * B, K), num_heads=self.num_heads,
        )[:, 0, :].reshape(T, B, D)

        # the short recent window: DIN target attention, multi-target form
        short_out = din_attention(params["short_att"], tgt, short_emb, short_mask)
        return esu_out, short_out, pooled

    def _score_catalog(self, params, users, overrides=None, items=None):
        """Full-catalog scoring with the long history gathered once a user:
        the catalog is the target-block axis of the GSU / ESU /
        short-attention stack. ``items``: optional (T,) item subset;
        ``overrides``: per-user (U, L) "seq" and "seq_long" / (U, F) feature
        rows of a request."""
        if items is None:
            items = torch.arange(self.n_items, device=self.device)
        n_users, n_items = users.shape[0], items.shape[0]
        table = self._token_table(params)
        long_seq = self._catalog_seq(users, overrides, key="seq_long")
        long_emb = self._token_embeds(params, long_seq, table)
        short_seq = self._catalog_seq(users, overrides)
        short_emb = self._token_embeds(params, short_seq, table)
        target = self._token_embeds(params, items, table)       # (n_items, TD)
        tgt = target[:, None, :].expand(n_items, n_users, target.shape[1])
        esu_out, short_out, _ = self._second_stage(
            params, tgt, long_emb, long_seq != self.pad_id, short_emb,
            short_seq != self.pad_id)
        D = esu_out.shape[-1]
        esu_rows = esu_out.transpose(0, 1).reshape(-1, D)
        short_rows = short_out.transpose(0, 1).reshape(-1, D)
        embeds, _, _ = self._field_embeds(
            params, self._catalog_pair_inputs(users, overrides, items))
        x = torch.cat([embeds.reshape(embeds.shape[0], -1), esu_rows, short_rows],
                      dim=1)
        h = mlp(params["mlp"], x)
        return dense(params["head"], h)[:, 0].reshape(n_users, n_items)

    def _forward(self, params, inputs, train):
        items = inputs["item"]
        embeds, _, _ = self._field_embeds(params, inputs)
        # one packed token table a forward for the three token gathers
        table = self._token_table(params)
        target = self._token_embeds(params, items, table)       # (TB, TD)

        long_seq = self._long_seq_for(inputs)
        long_emb = self._token_embeds(params, long_seq, table)
        if train and not self.long_history_grad:
            # the GSU / long branch trains on a frozen view of the token
            # table (the SIM paper trains its GSU apart): no backward
            # scatter-add of the B * long_max_len history rows. The table
            # still trains through the targets and the short window.
            long_emb = long_emb.detach()
        long_mask = long_seq != self.pad_id
        short_seq = self._seq_for(inputs)
        short_emb = self._token_embeds(params, short_seq, table)
        short_mask = short_seq != self.pad_id

        # shared-seq: the long history's gather and its backward run once a
        # row; every target block attends over the shared embeddings
        B = long_seq.shape[0]
        shared = target.shape[0] != B
        tgt = self._target_blocks(target, B) if shared else target[None]
        T, _, D = tgt.shape

        esu_out, short_out, pooled = self._second_stage(
            params, tgt, long_emb, long_mask, short_emb, short_mask,
            want_pool=train,
        )
        if shared:
            esu_rows = self._blocks_to_rows(esu_out)
            short_rows = self._blocks_to_rows(short_out)
        else:
            esu_rows, short_rows = esu_out[0], short_out[0]
        x = torch.cat([embeds.reshape(embeds.shape[0], -1), esu_rows, short_rows],
                      dim=1)
        h = mlp(params["mlp"], x, dropout_rate=self.dropout_rate, train=train,
                generator=self._dropout_gen)
        second = dense(params["head"], h)[:, 0]
        if not train:
            return second

        # the first stage, on the pool that came out of the selector product
        if shared:
            pooled = self._blocks_to_rows(pooled[None].expand(T, B, D))
        x1 = torch.cat([target, pooled], dim=1)
        h1 = mlp(params["first_mlp"], x1, dropout_rate=self.dropout_rate,
                 train=train, generator=self._dropout_gen)
        first = dense(params["first_head"], h1)[:, 0]
        return self.alpha * first + self.beta * second
