"""YouTubeRanking: a deep ranking net over the feature fields and the
mean-pooled behavior history.

Counterpart of ``librecommender_tpu/models/youtube_ranking.py``, with the same
constructor kwargs and parameter tree: the candidate's and the user's field
embeddings and the masked mean of the history's item embeddings go through
an MLP. With ``pallas_grad_scatter=True`` the history gather's gradient runs
through the row scatter-add kernel on the GPU.
"""
import torch

from ..bases.seq_base import SeqFeatBase
from ..ops.initializers import truncated_normal
from ..ops.nn import dense, init_dense, init_mlp, mlp
from ..utils.misc import aligned_rows


class YouTubeRanking(SeqFeatBase):
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
        if task == "rating":
            raise ValueError("YouTubeRanking is only suitable for ranking")
        super().__init__(
            task, data_info, loss_type, embed_size, n_epochs, lr, lr_decay,
            epsilon, reg, batch_size, sampler, num_neg, seed,
            lower_upper_bound, multi_sparse_combiner, device,
            recent_num=recent_num, random_num=random_num,
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
        if self.feats.has_sparse:
            params["sparse_embed"] = truncated_normal(
                generator, (self._sparse_rows(), D))
        if self.feats.has_dense:
            params["dense_embed"] = truncated_normal(
                generator, (self.feats.n_dense_fields, D))
        in_dim = self.n_fields * D + D  # fields + pooled history
        params["mlp"] = init_mlp(generator, in_dim, list(self.hidden_units),
                                 use_ln=self.use_bn)
        params["head"] = init_dense(generator, self.hidden_units[-1], 1)
        return params

    shared_seq = True  # pooling is target-independent: pool once per row

    def _pooled(self, params, seq):
        """(B, L) history -> (B, D) masked mean of its item embeddings."""
        seq_emb, mask = self._seq_item_embeds(params, seq)
        maskf = mask.to(seq_emb.dtype)[:, :, None]
        return (torch.sum(seq_emb * maskf, dim=1)
                / torch.clamp(torch.sum(maskf, dim=1), min=1.0))

    def _score_catalog(self, params, users, overrides=None, items=None):
        """Full-catalog scoring: the history is pooled once per user and the
        pooled vector repeats across the catalog. ``items``: optional (T,)
        item subset; ``overrides``: per-user (U, L) "seq" / (U, F) feature
        rows of a request."""
        if items is None:
            items = torch.arange(self.n_items, device=self.device)
        n_users, n_items = users.shape[0], items.shape[0]
        pooled = self._pooled(params, self._catalog_seq(users, overrides))
        pooled = pooled.repeat_interleave(n_items, dim=0)
        embeds, _, _ = self._field_embeds(
            params, self._catalog_pair_inputs(users, overrides, items))
        x = torch.cat([embeds.reshape(embeds.shape[0], -1), pooled], dim=1)
        h = mlp(params["mlp"], x)
        return dense(params["head"], h)[:, 0].reshape(n_users, n_items)

    def _forward(self, params, inputs, train):
        users = inputs["user"]
        embeds, _, _ = self._field_embeds(params, inputs)
        seq = self._seq_for(inputs)
        pooled = self._pooled(params, seq)
        B = seq.shape[0]
        if users.shape[0] != B:
            # [B positives; B*S interleaved negatives] share each row's
            # pooled history: tile it instead of gathering and pooling again
            S = users.shape[0] // B - 1
            pooled = torch.cat([pooled, pooled.repeat_interleave(S, dim=0)])
        x = torch.cat([embeds.reshape(embeds.shape[0], -1), pooled], dim=1)
        h = mlp(params["mlp"], x, dropout_rate=self.dropout_rate, train=train,
                generator=self._dropout_gen)
        return dense(params["head"], h)[:, 0]
