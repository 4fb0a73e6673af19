"""Graph structures built once on the host.

Counterpart of ``build_neighbor_table`` in
``librecommender_tpu/graph/adjacency.py``, copied as it is (the same seed, so
the same subsets). The edge lists and adjacency matrices of that file come
with the graph family.
"""
import numpy as np


def build_neighbor_table(consumed, n_rows, max_neighbors, pad):
    """Fixed-width neighbor table (n_rows, max_neighbors) padded with `pad`;
    rows with more neighbors keep a uniform random subset (deterministic
    seed); also returns counts (n_rows,)."""
    rng = np.random.default_rng(0)
    table = np.full((n_rows, max_neighbors), pad, dtype=np.int32)
    counts = np.zeros(n_rows, dtype=np.float32)
    for r, neigh in consumed.items():
        arr = np.unique(np.asarray(neigh, dtype=np.int64))
        if len(arr) > max_neighbors:
            arr = rng.choice(arr, max_neighbors, replace=False)
        table[int(r), : len(arr)] = arr
        counts[int(r)] = len(arr)
    return table, counts
