"""Host-side ranking utilities shared by score-matrix models (a numpy copy of
``librecommender_tpu/recommendation/ranking.py``).

Reference parity: libreco/recommendation/ranking.py:10 — consumed filtering
+ top-k + optional softmax^0.75 stochastic recommendation, with the
reference's exact edge semantics (ported battery: tests/test_rank_batch.py
vs reference tests/test_rank_reco.py):

- ``n_rec > n_items`` raises ValueError (ranking.py:21);
- consumed are filtered ONLY when ``n_rec + len(consumed) <= n_items``
  (ranking.py:38) — when the remainder can't fill the list, the reference
  returns the unfiltered top-k, consumed included;
- ``random_rec`` samples by ``softmax(raw preds)**0.75 + 1e-8``
  (ranking.py:66) — raw logits, not display probabilities;
- returned scores are sigmoid probabilities for the ranking task,
  applied after selection (ranking.py:52).

The heavy path (full-catalog scoring) runs on the GPU via ``ops/topk.py``;
this module covers the host-side variant used with precomputed numpy
scores and the ``random_rec`` sampling mode.
"""
import numpy as np


def rank_recommendations(
    task,
    user_ids,
    model_scores,
    n_rec,
    n_items,
    user_consumed,
    filter_consumed=True,
    random_rec=False,
    return_scores=False,
    np_rng=None,
):
    """model_scores: (U, n_items) numpy. Returns (U, n_rec) item ids."""
    if n_rec > n_items:
        raise ValueError(f"`n_rec` {n_rec} exceeds num of items {n_items}")
    raw = np.array(model_scores, dtype=np.float64, copy=True).reshape(
        -1, n_items
    )
    users = np.atleast_1d(np.asarray(user_ids))
    ids = np.empty((len(users), n_rec), dtype=np.int64)
    out_scores = np.empty((len(users), n_rec), dtype=np.float64)
    all_items = np.arange(n_items)
    keep = np.empty(n_items, dtype=bool)
    for row, u in enumerate(users):
        s = raw[row]
        consumed = user_consumed.get(int(u), ()) if filter_consumed else ()
        if len(consumed) and n_rec + len(consumed) <= n_items:
            keep[:] = True
            keep[np.fromiter(consumed, dtype=np.int64)] = False
            cand = all_items[keep]
        else:
            cand = all_items
        sc = s[cand]
        # the filter condition guarantees len(cand) >= n_rec
        take = n_rec
        if random_rec:
            # softmax over the RAW logits, tempered by ^0.75, floored so
            # no candidate has exactly zero probability
            p = np.exp(sc - sc.max())
            p = np.power(p / p.sum(), 0.75) + 1e-8
            p = p / p.sum()
            rng = np_rng if np_rng is not None else np.random.default_rng()
            chosen = rng.choice(len(cand), take, replace=False, p=p)
        else:
            chosen = np.argpartition(-sc, take - 1)[:take]
        chosen = chosen[np.argsort(-sc[chosen])]
        ids[row] = cand[chosen]
        out_scores[row] = sc[chosen]
    if return_scores:
        if task == "ranking":
            out_scores = 1.0 / (1.0 + np.exp(-out_scores))
        return ids, out_scores
    return ids
