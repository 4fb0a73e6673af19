"""Feature-embedding computation over the flat sparse index space.

Counterpart of ``librecommender_tpu/ops/embeddings.py``: sparse embeddings
with the multi-sparse combiners sum/mean/sqrtn, dense-value embeddings and
sequence pooling. All lookups are plain indexing on a single flat table, one
embedding matrix indexed by the global offset layout of
``feature/sparse.py``.
"""
import torch


def sparse_embeds(table, sparse_indices):
    """Flat-table lookup: (V, D) x (B, F) int -> (B, F, D)."""
    return table[sparse_indices.long()]


def dense_embeds(table, dense_values):
    """Per-field dense embedding scaled by the value.

    table (F_dense, D); dense_values (B, F_dense) -> (B, F_dense, D): each
    dense field owns one embedding vector multiplied by the scalar feature
    value.
    """
    return table[None, :, :] * dense_values[:, :, None]


def combine_multi_sparse(embeds, sparse_indices, multi_sparse_info, combiner):
    """Pool multi-sparse field groups into one embedding per group.

    embeds (B, F, D) laid out per the expanded sparse columns; group g spans
    ``field_offset[g] : field_offset[g] + field_len[g]``. Positions holding
    the group's OOV index (pad) are excluded from mean/sqrtn denominators.
    Returns (B, F', D) with F' = F - sum(field_len) + n_groups; non-grouped
    fields keep their order.
    """
    if combiner == "normal" or multi_sparse_info is None:
        return embeds
    offsets = list(multi_sparse_info.field_offset)
    lens = list(multi_sparse_info.field_len)
    oovs = list(multi_sparse_info.feat_oov)
    group_of = {o: g for g, o in enumerate(offsets)}

    pieces = []
    f = 0
    F = embeds.shape[1]
    while f < F:
        if f in group_of:
            g = group_of[f]
            o, l = offsets[g], lens[g]
            seg = embeds[:, o : o + l, :]                       # (B, l, D)
            valid = (sparse_indices[:, o : o + l] != int(oovs[g])).to(seg.dtype)
            summed = torch.sum(seg * valid[:, :, None], dim=1)  # (B, D)
            count = torch.sum(valid, dim=1, keepdim=True).clamp_min(1.0)
            if combiner == "sum":
                pooled = summed
            elif combiner == "mean":
                pooled = summed / count
            elif combiner == "sqrtn":
                pooled = summed / torch.sqrt(count)
            else:
                raise ValueError(f"unknown multi_sparse combiner: {combiner}")
            pieces.append(pooled[:, None, :])
            f = o + l
        else:
            pieces.append(embeds[:, f : f + 1, :])
            f += 1
    return torch.cat(pieces, dim=1)


def seq_mask(seq, pad_id):
    """(B, L) int seq -> (B, L) bool valid mask. Sequences are right-aligned
    and padded with ``pad_id`` (= n_items, the item OOV id)."""
    return seq != pad_id


def seq_mean_pool(item_table, seq, pad_id):
    """Mean-pool item embeddings over a behavior sequence, ignoring padding.

    seq (B, L) int inner item ids.
    """
    embeds = item_table[seq.long()]                              # (B, L, D)
    mask = (seq != pad_id).to(embeds.dtype)
    summed = torch.sum(embeds * mask[:, :, None], dim=1)
    return summed / torch.sum(mask, dim=1, keepdim=True).clamp_min(1.0)
