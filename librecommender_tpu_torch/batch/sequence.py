"""User behavior-sequence construction (host-side, vectorized).

Counterpart of ``librecommender_tpu/batch/sequence.py``, copied as it is:
``build_train_seqs`` gives each training row the history strictly before its
position (recent or random mode), ``get_recent_seqs`` each user's cached
recent history plus the all-pad row of the cold user.

Layout contract: sequences are **right-aligned** (most recent event last,
padding on the left) and padded with ``pad_id == n_items`` (the item-OOV
row). Device ops mask by ``seq != pad_id``. Right alignment lets the
training matrix be built with one sliding-window view per user instead of a
per-row Python loop.
"""
import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def build_train_seqs(user_indices, item_indices, n_items, max_len,
                     mode="recent", seed=42):
    """Per-row history before each interaction.

    Returns (seqs (N, L) int32 right-aligned, lens (N,) float32).
    """
    N = len(user_indices)
    pad = n_items
    seqs = np.full((N, max_len), pad, dtype=np.int32)
    lens = np.zeros(N, dtype=np.float32)
    order = np.argsort(user_indices, kind="stable")
    sorted_users = user_indices[order]
    bounds = np.nonzero(np.diff(sorted_users))[0] + 1
    rng = np.random.default_rng(seed)
    for rows in np.split(order, bounds):
        items_u = np.asarray(item_indices[rows], dtype=np.int32)
        n = len(items_u)
        if mode == "random":
            # sample up to L random events from the user's *full* history
            # before the target position (reference `random` seq mode)
            for j in range(n):
                avail = items_u[:j]
                if avail.size == 0:
                    continue
                take = min(max_len, avail.size)
                picked = rng.choice(avail, take, replace=False)
                seqs[rows[j], max_len - take :] = picked
                lens[rows[j]] = take
        else:
            padded = np.concatenate([np.full(max_len, pad, np.int32), items_u])
            windows = sliding_window_view(padded, max_len)[:n]
            seqs[rows] = windows
            lens[rows] = np.minimum(np.arange(n), max_len)
    return seqs, lens


def get_recent_seqs(n_users, user_consumed, n_items, max_len):
    """Cached per-user recent history (n_users + 1, L) right-aligned; the
    trailing row is the all-pad OOV/cold user."""
    pad = n_items
    seqs = np.full((n_users + 1, max_len), pad, dtype=np.int32)
    lens = np.zeros(n_users + 1, dtype=np.float32)
    for u in range(n_users):
        consumed = user_consumed.get(u, [])
        take = min(max_len, len(consumed))
        if take:
            seqs[u, max_len - take :] = consumed[-take:]
            lens[u] = take
    return seqs, lens
