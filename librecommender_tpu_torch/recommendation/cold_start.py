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

