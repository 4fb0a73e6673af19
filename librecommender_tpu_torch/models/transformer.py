"""Transformer (BST): a behavior-sequence transformer ranking model.

Counterpart of ``librecommender_tpu/models/transformer.py``, with the same
constructor kwargs and parameter tree. Each sequence token is the item
embedding aggregated with the item's features (``feat_agg_mode``: 'concat'
flattens the item's sparse and dense field embeddings into the token,
'elementwise' adds layer-normed field sums, None keeps bare item
embeddings); the target item is appended to the sequence, positions are
added ('trainable' table or 'sinusoidal'), a stack of pre-LN encoder layers
(optionally causal) attends over sequence and target, and the output at the
target position joins the other feature fields in an MLP head.

``compute_dtype="bf16"`` (the default) runs the encoder in bfloat16 with the
layer parameters cast at each use; they stay float32, as do the head and the
loss.
"""
import torch

from ..bases.seq_base import SeqFeatBase
from ..ops.initializers import truncated_normal
from ..ops.nn import (
    dense,
    init_dense,
    init_mlp,
    init_transformer_layer,
    mlp,
    positional_encoding,
    transformer_layer,
    transformer_target_out,
)
from ..utils.misc import aligned_rows


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


class Transformer(SeqFeatBase):
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
        num_heads=2,
        num_tfm_layers=1,
        positional_embedding="trainable",
        use_causal_mask=False,
        feat_agg_mode="concat",
        multi_sparse_combiner="sqrtn",
        compute_dtype="bf16",
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
        if compute_dtype not in ("bf16", "f32", None):
            raise ValueError("compute_dtype must be 'bf16', 'f32' or None")
        if positional_embedding not in ("trainable", "sinusoidal"):
            raise ValueError(
                "`positional_embedding` must be `trainable` or `sinusoidal`."
            )
        if feat_agg_mode not in ("concat", "elementwise", None):
            raise ValueError("`feat_agg_mode` must be `concat` or `elementwise`.")
        self.compute_dtype = compute_dtype
        self.use_bn = use_bn
        self.dropout_rate = dropout_rate or 0.0
        self.num_heads = num_heads
        self.num_tfm_layers = num_tfm_layers
        self.positional_embedding = positional_embedding
        self.use_causal_mask = use_causal_mask
        self.feat_agg_mode = feat_agg_mode

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
        self._init_token_norms(params)
        if self.positional_embedding == "trainable":
            params["pos_embed"] = truncated_normal(
                generator, (self.max_seq_len + 1, TD), scale=0.02)
        params["tfm_layers"] = [
            init_transformer_layer(generator, TD, self.num_heads, 4 * TD)
            for _ in range(self.num_tfm_layers)
        ]
        in_dim = self.n_fields * D + TD
        params["mlp"] = init_mlp(generator, in_dim, list(self.hidden_units),
                                 use_ln=self.use_bn)
        params["head"] = init_dense(generator, self.hidden_units[-1], 1)
        return params

    shared_seq = True  # pos/neg targets share each row's history tokens

    def _shared_encoder_ok(self):
        """Whether the sequence tokens' outputs are target-independent (one
        layer, or a causal stack), so that ``transformer_target_out`` shares
        them across targets."""
        return self.num_tfm_layers == 1 or self.use_causal_mask

    def _positions(self, params, n, width):
        if self.positional_embedding == "trainable":
            return params["pos_embed"]
        return positional_encoding(n, width, self.device)

    def _encoder_inputs(self, params, *tokens):
        """The layer parameters and the tokens in the compute dtype."""
        layers = params["tfm_layers"]
        if self.compute_dtype == "bf16":
            layers = _cast_tree(layers, torch.bfloat16)
            tokens = [t.to(torch.bfloat16) for t in tokens]
        return layers, tokens

    def _forward(self, params, inputs, train):
        items = inputs["item"]
        embeds, _, _ = self._field_embeds(params, inputs)
        table = self._token_table(params)
        seq = self._seq_for(inputs)
        seq_emb = self._token_embeds(params, seq, table)        # (B, L, TD)
        mask = seq != self.pad_id
        target = self._token_embeds(params, items, table)       # (TB, TD)
        B = seq_emb.shape[0]
        if self._shared_encoder_ok():
            # only the target position feeds the head and the sequence
            # tokens' outputs do not depend on it: share their work across
            # targets instead of running the encoder over (T*B, L+1)
            target_out = self._encode_fast(params, seq_emb, mask, target, B)
        else:
            target_out = self._encode_broadcast(params, seq_emb, mask, target, B)
        flat = torch.cat([embeds.reshape(embeds.shape[0], -1), target_out], dim=1)
        h = mlp(params["mlp"], flat, dropout_rate=self.dropout_rate,
                train=train, generator=self._dropout_gen)
        return dense(params["head"], h)[:, 0]

    def _encode_fast(self, params, seq_emb, mask, target, B):
        """Shared-seq encoder: the sequence's K/V once, per-target rows only."""
        L, TD = seq_emb.shape[1], seq_emb.shape[2]
        shared = target.shape[0] != B
        tgt = self._target_blocks(target, B) if shared else target[None]
        pos = self._positions(params, L + 1, TD)
        layers, (seq_tok, tgt_tok) = self._encoder_inputs(
            params, seq_emb + pos[None, :L], tgt + pos[L][None, None])
        out = transformer_target_out(
            layers, seq_tok, mask, tgt_tok,
            num_heads=self.num_heads, causal=self.use_causal_mask,
        ).to(torch.float32)                                     # (T, B, TD)
        return self._blocks_to_rows(out) if shared else out[0]

    def _score_catalog(self, params, users, overrides=None, items=None):
        """Full-catalog scoring with the per-user sequence work shared across
        items: the catalog is the target-block axis of the shared-seq encoder
        (T = n_items), so the history's tokens and K/V run once a user.
        Deeper non-causal stacks fan every (user, item) pair out through the
        general encoder. ``items``: optional (T,) item subset;
        ``overrides``: per-user (U, L) "seq" / (U, F) feature rows of a
        request."""
        if items is None:
            items = torch.arange(self.n_items, device=self.device)
        n_users, n_items = users.shape[0], items.shape[0]
        pair_inputs = self._catalog_pair_inputs(users, overrides, items)
        if not self._shared_encoder_ok():
            if overrides and overrides.get("seq") is not None:
                pair_inputs["seq"] = overrides["seq"].repeat_interleave(
                    n_items, dim=0)
            logits = self._forward(params, pair_inputs, train=False)
            return logits.reshape(n_users, n_items)
        table = self._token_table(params)
        seq = self._catalog_seq(users, overrides)
        seq_emb = self._token_embeds(params, seq, table)        # (U, L, TD)
        mask = seq != self.pad_id
        target = self._token_embeds(params, items, table)       # (n_items, TD)
        L, TD = seq_emb.shape[1], seq_emb.shape[2]
        pos = self._positions(params, L + 1, TD)
        tgt = target[:, None, :].expand(n_items, n_users, TD)
        layers, (seq_tok, tgt_tok) = self._encoder_inputs(
            params, seq_emb + pos[None, :L], tgt + pos[L][None, None])
        out = transformer_target_out(
            layers, seq_tok, mask, tgt_tok,
            num_heads=self.num_heads, causal=self.use_causal_mask,
        ).to(torch.float32)                                     # (n_items, U, TD)
        target_out = out.transpose(0, 1).reshape(n_users * n_items, TD)
        embeds, _, _ = self._field_embeds(params, pair_inputs)
        flat = torch.cat([embeds.reshape(embeds.shape[0], -1), target_out], dim=1)
        h = mlp(params["mlp"], flat)
        return dense(params["head"], h)[:, 0].reshape(n_users, n_items)

    def _encode_broadcast(self, params, seq_emb, mask, target, B):
        """The full encoder over every (target, sequence) pair: the general
        path (deeper non-causal stacks need the sequence tokens' outputs).
        The history's token gather and its backward still run once a row:
        the broadcast's backward is a sum over the targets."""
        L, TD = seq_emb.shape[1], seq_emb.shape[2]
        shared = target.shape[0] != B
        if shared:
            tgt = self._target_blocks(target, B)                # (T, B, TD)
            T = tgt.shape[0]
            x = torch.cat([
                seq_emb[None].expand(T, B, L, TD).reshape(T * B, L, TD),
                tgt.reshape(T * B, 1, TD),
            ], dim=1)                                           # (TB, L+1, TD)
            full_mask = torch.cat([
                mask[None].expand(T, B, L).reshape(T * B, L),
                torch.ones((T * B, 1), dtype=torch.bool, device=mask.device),
            ], dim=1)
        else:
            x = torch.cat([seq_emb, target[:, None, :]], dim=1)
            full_mask = torch.cat([
                mask, torch.ones((mask.shape[0], 1), dtype=torch.bool,
                                 device=mask.device)], dim=1)
        x = x + self._positions(params, x.shape[1], TD)[None, : x.shape[1]]
        layers, (x,) = self._encoder_inputs(params, x)
        for layer in layers:
            x = transformer_layer(layer, x, mask=full_mask,
                                  causal=self.use_causal_mask,
                                  num_heads=self.num_heads)
        target_out = x[:, -1, :].to(torch.float32)              # (TB, TD)
        if shared:
            target_out = self._blocks_to_rows(target_out.reshape(T, B, TD))
        return target_out
