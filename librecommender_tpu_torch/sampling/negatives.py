"""Host-side (numpy) negative samplers.

A copy of ``librecommender_tpu/sampling/negatives.py``: the same numpy
generator gives the same draws in both packages, which is what lets the
tests feed both trainers identical batches.
"""
import numpy as np


def negatives_from_random(np_rng, n_items, items_pos, num_neg, items=None, tolerance=10):
    items_pos = np.repeat(items_pos, num_neg) if num_neg > 1 else np.asarray(items_pos)
    if items is not None and num_neg > 1:
        items = np.repeat(items, num_neg)
    replace = len(items_pos) >= n_items
    negatives = np_rng.choice(n_items, size=len(items_pos), replace=replace)
    for _ in range(tolerance):
        bad = negatives == items_pos
        if items is not None and len(items) > 0:
            bad |= negatives == items
        bad_idx = np.nonzero(bad)[0]
        if bad_idx.size == 0:
            break
        negatives[bad_idx] = np_rng.choice(n_items, size=bad_idx.size, replace=True)
    return negatives


def negatives_from_popular(np_rng, n_items, items_pos, num_neg, items=None, probs=None):
    items_pos = np.repeat(items_pos, num_neg) if num_neg > 1 else np.asarray(items_pos)
    if items is not None and num_neg > 1:
        items = np.repeat(items, num_neg)
    negatives = np_rng.choice(n_items, size=len(items_pos), replace=True, p=probs)
    bad = negatives == items_pos
    if items is not None and len(items) > 0:
        bad |= negatives == items
    bad_idx = np.nonzero(bad)[0]
    if bad_idx.size > 0:
        negatives[bad_idx] = np_rng.choice(n_items, size=bad_idx.size, replace=True, p=probs)
    return negatives


def negatives_from_out_batch(np_rng, n_items, items_pos, items, num_neg):
    """Sample from items outside the current batch (for listwise training)."""
    sample_num = len(items_pos) * num_neg
    candidates = np.setdiff1d(np.arange(n_items), np.union1d(items_pos, items))
    if candidates.size == 0:
        return np_rng.choice(n_items, size=sample_num, replace=True)
    replace = sample_num >= candidates.size
    return np_rng.choice(candidates, size=sample_num, replace=replace)


def negatives_from_unconsumed(
    user_consumed_set, users, items, n_items, num_neg, tolerance=10, seed=42
):
    """Sample negatives each user has never consumed.

    Vectorized rejection sampling: resample colliding entries up to
    ``tolerance`` rounds, then relax the constraint to "not the paired
    positive item" for any remainder (mirrors the reference's fallback).
    """
    np_rng = np.random.default_rng(seed)
    users_rep = np.repeat(np.asarray(users), num_neg)
    items_rep = np.repeat(np.asarray(items), num_neg)
    total = len(users_rep)
    negatives = np_rng.integers(0, n_items, total)

    def _consumed_mask(cand):
        return np.fromiter(
            (int(c) in user_consumed_set.get(int(u), ()) for c, u in zip(cand, users_rep)),
            dtype=bool,
            count=total,
        )

    for _ in range(tolerance):
        bad = (negatives == items_rep) | _consumed_mask(negatives)
        bad_idx = np.nonzero(bad)[0]
        if bad_idx.size == 0:
            break
        negatives[bad_idx] = np_rng.integers(0, n_items, bad_idx.size)
    else:
        # relax: only avoid the paired positive
        for _ in range(tolerance):
            bad_idx = np.nonzero(negatives == items_rep)[0]
            if bad_idx.size == 0:
                break
            negatives[bad_idx] = np_rng.integers(0, n_items, bad_idx.size)
    return negatives


def neg_probs_from_frequency(item_consumed, n_items, temperature):
    """Sampling distribution ∝ item frequency ** temperature."""
    freqs = np.array(
        [len(set(item_consumed[i])) if i in item_consumed else 0 for i in range(n_items)],
        dtype=np.float64,
    )
    if temperature != 1.0:
        freqs = np.power(freqs, temperature)
    return freqs / np.sum(freqs)


def pos_probs_from_frequency(item_consumed, n_users, n_items, alpha):
    """Word2vec-style subsampling keep-probabilities for positives, one per
    item (every item must have consumers): ``(sqrt(f / alpha) + 1) *
    alpha / f`` at the item's share ``f`` of distinct consumers."""
    probs = []
    for i in range(n_items):
        prob = len(set(item_consumed[i])) / n_users
        prob = (np.sqrt(prob / alpha) + 1) * (alpha / prob)
        probs.append(prob)
    return probs
