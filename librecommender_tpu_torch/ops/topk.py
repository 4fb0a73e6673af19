"""Full-catalog scoring and top-k retrieval.

Counterpart of ``librecommender_tpu/ops/topk.py``. From embeddings every call
goes through the streaming top-k (``ops/streaming_topk.py``): the CUDA kernel
for tensors on the GPU, its plain version for tensors on the CPU. It
over-fetches ``k = n_rec + max consumed`` and drops consumed items on the
host, the candidate policy of the reference serving tier
(libserving/sanic_serving/online_deploy.py). ``topk_from_scores`` ranks a
score matrix a model's forward pass already computed.
"""
import numpy as np
import torch

from .streaming_topk import streaming_topk

# the over-fetch is capped here: a row underfills only if more than
# MAX_FETCH - n_rec of its consumed items land in its global top MAX_FETCH
MAX_FETCH = 2048


def topk_from_embeddings(user_embeds, item_embeds, n_rec, user_consumed=None,
                         user_ids=None, filter_consumed=True):
    """Exact top-n_rec per user with optional consumed filtering.

    ``user_embeds`` (U, D) or (D,) and ``item_embeds`` (N, D) are float32
    tensors on one device. Returns host numpy (ids (U, n_rec) int32, scores
    (U, n_rec) float32).
    """
    if user_embeds.dim() == 1:
        user_embeds = user_embeds[None]
    consumed = None
    if filter_consumed and user_consumed is not None and user_ids is not None:
        consumed = pad_consumed(user_consumed, user_ids, n_rec=int(n_rec),
                                n_items=int(item_embeds.shape[0]))
    return _streaming_topk(user_embeds, item_embeds, n_rec, consumed)


def _streaming_topk(user_embeds, item_embeds, n_rec, consumed):
    """Over-fetch k = n_rec + max consumed count, filter consumed on the
    host, trim to n_rec."""
    n_users, n_items = user_embeds.shape[0], item_embeds.shape[0]
    width = 0
    if consumed is not None:
        width = int((consumed >= 0).sum(axis=1).max())
    ids, scores = streaming_topk(
        user_embeds, item_embeds, fetch_size(n_rec, width, n_items)
    )
    ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
    if width:
        # drop consumed candidates per row, keep order, trim to n_rec
        keep = ~consumed_mask(ids, consumed, n_items)
        pos = np.cumsum(keep, axis=1) - 1        # each kept candidate's slot
        rows, cols = np.nonzero(keep & (pos < int(n_rec)))
        out_i = np.zeros((n_users, int(n_rec)), np.int32)
        out_s = np.full((n_users, int(n_rec)), -np.inf, np.float32)
        out_i[rows, pos[rows, cols]] = ids[rows, cols]
        out_s[rows, pos[rows, cols]] = scores[rows, cols]
        return out_i, out_s
    return ids[:, : int(n_rec)], scores[:, : int(n_rec)]


def consumed_mask(ids, consumed, n_items):
    """(U, k) bool: whether ``ids[r, j]`` is in row r of ``consumed`` (U, C),
    padded with -1. Each (row, id) pair becomes one key, row * (n_items + 1)
    + id, and the candidates' keys are looked up in the sorted consumed
    keys, so memory grows as U x (k + C), not U x k x C."""
    stride = np.int64(n_items) + 1
    valid = consumed >= 0
    rows = np.nonzero(valid)[0].astype(np.int64)
    held = np.sort(rows * stride + consumed[valid])
    if held.size == 0:
        return np.zeros(ids.shape, bool)
    keys = np.arange(ids.shape[0], dtype=np.int64)[:, None] * stride + ids
    at = np.minimum(np.searchsorted(held, keys), held.size - 1)
    return held[at] == keys


def fetch_size(n_rec, width, n_items):
    """k the streaming top-k is asked for: n_rec plus the widest consumed
    row, capped at MAX_FETCH (or n_rec if larger) and at the catalog."""
    kk = int(n_rec) + int(width)
    if kk > MAX_FETCH:
        kk = max(int(n_rec), MAX_FETCH)
    return min(int(n_items), kk)


def pad_consumed(user_consumed, user_ids, n_rec=None, n_items=None):
    """(U, C) int32 consumed matrix padded with -1, or None if all rows are
    empty. C is rounded up to a power of two.

    ``n_rec``/``n_items``: when given, a user whose unconsumed remainder
    can't fill ``n_rec`` gets an EMPTY row, the reference's can't-filter
    passthrough (libreco/recommendation/ranking.py:38 filters only when
    ``n_rec + len(consumed) <= n_items``)."""
    lists = [np.asarray(user_consumed.get(int(u), []), dtype=np.int64)
             for u in np.atleast_1d(user_ids)]
    if n_rec is not None and n_items is not None:
        lists = [c if n_rec + len(c) <= n_items else c[:0] for c in lists]
    max_len = max((len(c) for c in lists), default=0)
    if max_len == 0:
        return None
    width = 1 << (max_len - 1).bit_length()
    consumed = np.full((len(lists), width), -1, dtype=np.int32)
    for i, c in enumerate(lists):
        consumed[i, : len(c)] = c
    return consumed


def topk_lastdim_small(x, k):
    """Exact top-k over a short last axis by an (L, L) rank matrix:
    rank[l] = #{j: x_j > x_l} + #{j < l: x_j == x_l}, a permutation even
    under ties, which go to the lowest index. Returns (values, indices)."""
    top_vals, top_idx, _ = topk_lastdim_small_onehot(x, k)
    return top_vals, top_idx


def topk_lastdim_small_onehot(x, k):
    """``topk_lastdim_small`` that also returns the (..., k, L) selection
    one-hot, so that a caller selects rows with a batched product (whose
    backward is a product too) instead of an index gather and its
    scatter-add."""
    L = x.shape[-1]
    gt = x[..., None, :] > x[..., :, None]              # [l, j]: x_j > x_l
    eq = x[..., None, :] == x[..., :, None]
    pos = torch.arange(L, device=x.device)
    jlt = pos[None, :] < pos[:, None]
    rank = torch.sum(gt, dim=-1) + torch.sum(eq & jlt, dim=-1)   # (..., L)
    onehot = rank[..., None, :] == torch.arange(k, device=x.device)[:, None]  # (..., k, L)
    top_idx = torch.sum(torch.where(onehot, pos.to(torch.int32), 0), dim=-1,
                        dtype=torch.int32)
    # where (not a multiply) keeps a -inf selection exact and NaN-free
    top_vals = torch.sum(torch.where(onehot, x[..., None, :], 0.0), dim=-1)
    return top_vals, top_idx, onehot


def topk_from_scores(scores, consumed, k):
    """Top-k over a precomputed (U, N) score tensor with consumed masking;
    ties go to the lower item id, as ``jax.lax.top_k`` breaks them
    (``torch.topk`` promises no order among equal scores, so this is a stable
    descending sort). ``consumed``: (U, C) ids padded with -1 (numpy or
    tensor), or None. Returns (ids (U, k) int64, scores (U, k)) on the
    scores' device."""
    if consumed is not None and consumed.shape[1] > 0:
        consumed = torch.as_tensor(consumed, device=scores.device).long()
        rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
        rows = rows.expand_as(consumed)[consumed >= 0]
        scores = scores.clone()
        scores[rows, consumed[consumed >= 0]] = float("-inf")
    top_scores, top_ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return top_ids[:, :k], top_scores[:, :k]
