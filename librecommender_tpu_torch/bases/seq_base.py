"""Base for sequence-aware CTR models (DIN, YouTubeRanking, Transformer,
SIM).

Counterpart of ``librecommender_tpu/bases/seq_base.py``. Extends FeatBase
with behavior sequences: training rows carry the history *before* the target
position (built once, host-side, vectorized: ``batch/sequence.py``);
inference gathers each user's cached recent history from a device-resident
table inside the forward, so predict/recommend need no host-side sequence
assembly.
"""
import numpy as np
import torch
import torch.nn.functional as F

from .feat_base import FeatBase
from ..batch.sequence import build_train_seqs, get_recent_seqs
from ..ops.nn import init_layer_norm, layer_norm
from ..ops.row_scatter import gather_rows, use_pallas_grad_scatter
from ..utils.validate import check_seq_mode


class SeqFeatBase(FeatBase):
    def __init__(self, *args, recent_num=10, random_num=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.seq_mode, self.max_seq_len = check_seq_mode(recent_num, random_num)
        self.recent_seq_table = None  # (n_users + 1, L) device tensor

    @property
    def pad_id(self):
        return self.n_items

    def batch_extras(self, train_data):
        seqs, _ = build_train_seqs(
            np.asarray(train_data.user_indices),
            np.asarray(train_data.item_indices),
            self.n_items,
            self.max_seq_len,
            mode=self.seq_mode,
            seed=self.seed,
        )
        return {"seq": seqs}

    def touched_indices(self, batch):
        out = super().touched_indices(batch)
        for key in batch:
            # history positions also touch the item table (pad positions
            # index the item-OOV row, which exists in the aligned table)
            if key.startswith("seq"):
                out["item_embed"] = torch.cat(
                    [out["item_embed"], batch[key].reshape(-1)]
                )
                if self.feat_agg_mode is not None and self.feats.has_sparse \
                        and self.feats.item_sparse is not None:
                    # feature-augmented tokens also gradient the seq items'
                    # sparse feature rows
                    out["sparse_embed"] = torch.cat([
                        out["sparse_embed"],
                        self.feats.item_sparse[batch[key].long()].reshape(-1),
                    ])
        return out

    # ------------------------------------------------- seq token construction
    # feature-aggregated sequence tokens: 'concat' flattens each item's
    # sparse/dense field embeddings into its token, 'elementwise' adds
    # layer-normed field sums, None keeps bare item embeddings.
    feat_agg_mode = None

    def _token_field_counts(self):
        if self.feat_agg_mode is None or self.feats is None:
            return 0, 0
        f_s = len(self.feats.item_sparse_pos) if self.feats.has_sparse else 0
        f_d = len(self.feats.item_dense_pos) if self.feats.has_dense else 0
        return f_s, f_d

    @property
    def token_dim(self):
        f_s, f_d = self._token_field_counts()
        if self.feat_agg_mode == "concat":
            return self.embed_size * (1 + f_s + f_d)
        return self.embed_size

    def _init_token_norms(self, params):
        """Add the elementwise-mode LN params (no-op otherwise)."""
        f_s, f_d = self._token_field_counts()
        if self.feat_agg_mode == "elementwise":
            if f_s:
                params["tok_ln_sparse"] = init_layer_norm(self.embed_size, self.device)
            if f_d:
                params["tok_ln_dense"] = init_layer_norm(self.embed_size, self.device)
        return params

    # catalogs up to this size get the packed token table (below); beyond
    # it the per-id assembly is cheaper than materializing all tokens
    token_pack_max_items = 65536

    def _token_pack_ok(self):
        f_s, f_d = self._token_field_counts()
        return bool(f_s or f_d) and (self.n_items + 1) <= self.token_pack_max_items

    def _token_table(self, params):
        """The packed token table, or None where tokens are assembled per id.

        A token is a pure function of the item id, so for catalogs under
        ``token_pack_max_items`` the token vectors are assembled for ALL items
        once and every lookup is one gather: assembling per sequence position
        pays the feature gathers, their scatter-adds and the concat once per
        position per field, B * L rows each, where the packed form pays them
        once per catalog row. Nothing merges two builds of one step here, so
        a forward builds the table once and hands it to each
        ``_token_embeds`` call. Rows are padded to a multiple of 8, as in the
        JAX package."""
        if not self._token_pack_ok():
            return None
        n = self.n_items + 1
        all_ids = torch.arange(n, dtype=torch.int32, device=self.device)
        table = self._token_embeds_raw(params, all_ids)
        pad = (-n) % 8
        return F.pad(table, (0, 0, 0, pad)) if pad else table

    def _token_embeds(self, params, ids, table=None):
        """Item ids (any shape) -> feature-aggregated tokens (..., token_dim).
        Pad/OOV ids index the OOV row of each table. ``table``: the packed
        token table of this forward (``_token_table``), built here when it is
        not given."""
        if table is None:
            table = self._token_table(params)
        if table is not None:
            return self._grad_aware_gather(table, ids)
        return self._token_embeds_raw(params, ids)

    # True: the sequence gathers' gradient runs through the row scatter-add
    # kernel (ops/row_scatter.py); "auto": where the gather has enough ids
    # per table row for it; False: autograd's own index_put_
    pallas_grad_scatter = False

    def _grad_aware_gather(self, table, ids):
        """Gather with a swappable backward scatter-add."""
        mode = self.pallas_grad_scatter
        if mode is True or (
            mode == "auto" and use_pallas_grad_scatter(table.shape, ids.numel())
        ):
            return gather_rows(table, ids)
        return table[ids]

    def _token_embeds_raw(self, params, ids):
        base = self._grad_aware_gather(params["item_embed"], ids)
        f_s, f_d = self._token_field_counts()
        if not (f_s or f_d):
            return base
        parts = [base]
        if f_s:
            rows = self.feats.item_sparse[ids]            # (..., F_s)
            se = self._train_lookup(params["sparse_embed"], rows)  # (..., F_s, D)
            if self.feat_agg_mode == "concat":
                parts.append(se.reshape(*se.shape[:-2], -1))
            else:
                parts.append(
                    torch.sum(layer_norm(params["tok_ln_sparse"], se), dim=-2)
                )
        if f_d:
            vals = self.feats.item_dense[ids]             # (..., F_d)
            dvecs = params["dense_embed"][self.feats.item_dense_pos]  # (F_d, D)
            de = vals[..., None] * dvecs                  # (..., F_d, D)
            if self.feat_agg_mode == "concat":
                parts.append(de.reshape(*de.shape[:-2], -1))
            else:
                parts.append(
                    torch.sum(layer_norm(params["tok_ln_dense"], de), dim=-2)
                )
        if self.feat_agg_mode == "concat":
            return torch.cat(parts, dim=-1)
        return sum(parts)

    @staticmethod
    def _target_blocks(target, n_seq_rows):
        """Map (T*B, D) training rows, laid out [B positives; B*S negatives
        interleaved per row by loss_fn's repeat], to (T, B, D) blocks
        aligned with the (B, ...) shared-seq tensors."""
        B = n_seq_rows
        S = target.shape[0] // B - 1
        q_pos = target[:B][None]
        q_neg = target[B:].reshape(B, S, -1).transpose(0, 1)
        return torch.cat([q_pos, q_neg], dim=0)                 # (S+1, B, D)

    @staticmethod
    def _blocks_to_rows(out):
        """Inverse of _target_blocks on the output side: (T, B, D) ->
        (T*B, D) restoring the [positives; interleaved negatives] order."""
        B = out.shape[1]
        S = out.shape[0] - 1
        return torch.cat(
            [out[0], out[1:].transpose(0, 1).reshape(B * S, -1)]
        )

    def _seq_for(self, inputs):
        """Sequence from the batch if present, else the user's cached recent
        history gathered on the device."""
        if "seq" in inputs:
            return inputs["seq"]
        return self.recent_seq_table[inputs["user"]]

    def _seq_item_embeds(self, params, seq):
        """(B, L) -> (B, L, D) item embeddings + (B, L) valid mask.

        Pad positions index the item-OOV row; masking excludes them from
        pooling/attention. The gather's gradient follows
        ``pallas_grad_scatter``, as the token gathers' does.
        """
        embeds = self._grad_aware_gather(params["item_embed"], seq)
        mask = seq != self.pad_id
        return embeds, mask

    def build_model_shell(self):
        super().build_model_shell()
        seqs, _ = get_recent_seqs(
            self.n_users, self.user_consumed, self.n_items, self.max_seq_len
        )
        self.recent_seq_table = torch.from_numpy(seqs).to(self.device)
