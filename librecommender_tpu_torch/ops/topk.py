"""Full-catalog scoring and top-k retrieval.

Counterpart of ``librecommender_tpu/ops/topk.py``. Every call goes through
the streaming top-k (``ops/streaming_topk.py``): the CUDA kernel for tensors
on the GPU, its plain version for tensors on the CPU. It over-fetches
``k = n_rec + max consumed`` and drops consumed items on the host, the
candidate policy of the reference serving tier
(libserving/sanic_serving/online_deploy.py).
"""
import numpy as np

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
        keep = ~(ids[:, :, None] == consumed[:, None, :]).any(-1)
        out_i = np.zeros((n_users, int(n_rec)), np.int32)
        out_s = np.full((n_users, int(n_rec)), -np.inf, np.float32)
        for r in range(n_users):
            sel = np.flatnonzero(keep[r])[: int(n_rec)]
            out_i[r, : len(sel)] = ids[r, sel]
            out_s[r, : len(sel)] = scores[r, sel]
        return out_i, out_s
    return ids[:, : int(n_rec)], scores[:, : int(n_rec)]


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
