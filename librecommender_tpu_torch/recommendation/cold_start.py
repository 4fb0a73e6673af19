"""Cold-start recommendation strategies (a numpy copy of
``librecommender_tpu/recommendation/cold_start.py``).

Reference parity: libreco/recommendation/cold_start.py:20 — 'average' scores
the unknown user through the OOV embedding row (trained-row mean), 'popular'
returns the most consumed items.
"""
import numpy as np


def popular_recommendations(data_info, inner_id, n_rec, np_rng=None):
    popular = data_info.popular_items[:n_rec]
    if inner_id:
        item2id = data_info.item2id
        return np.asarray([item2id[i] for i in popular])
    return np.asarray(popular)


def cold_start_rec(data_info, default_recs, cold_start, users, n_rec, inner_id):
    """{user: recommendations} for unknown users: the model's default
    ('average') recommendations, or the popular items."""
    if cold_start not in ("average", "popular"):
        raise ValueError(f"Unknown cold start strategy: {cold_start}")
    result = {}
    for u in users:
        if cold_start == "popular" or default_recs is None:
            result[u] = popular_recommendations(data_info, inner_id, n_rec)
        else:
            recs = np.asarray(default_recs[:n_rec])
            result[u] = recs if inner_id else np.asarray(
                [data_info.id2item[int(i)] for i in recs]
            )
    return result
