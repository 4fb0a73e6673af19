"""Graph structures built once on the host.

Counterpart of ``build_edges``, ``build_dense_adjacency`` and
``build_neighbor_table`` in ``librecommender_tpu/graph/adjacency.py``, copied
as they are (the same seed, so the same subsets): edge lists with symmetric
normalised weights and the dense padded adjacency for full-graph propagation
(LightGCN, NGCF), and fixed-width neighbour tables. PinSage's walk
neighbourhoods come with the i2i slice.
"""
import numpy as np


def build_edges(user_consumed, n_users, n_items):
    """Edge arrays from the consumed dict: (edge_u, edge_i, edge_w) where
    edge_w = 1/sqrt(deg_u * deg_i) (symmetric normalization). Edges are
    sorted by user id (ties by item)."""
    us, its = [], []
    for u, items in user_consumed.items():
        uniq = np.unique(np.asarray(items, dtype=np.int64))
        us.append(np.full(len(uniq), int(u), np.int32))
        its.append(uniq.astype(np.int32))
    edge_u = np.concatenate(us) if us else np.zeros(0, np.int32)
    edge_i = np.concatenate(its) if its else np.zeros(0, np.int32)
    order = np.lexsort((edge_i, edge_u))
    edge_u, edge_i = edge_u[order], edge_i[order]
    deg_u = np.bincount(edge_u, minlength=n_users).astype(np.float32)
    deg_i = np.bincount(edge_i, minlength=n_items).astype(np.float32)
    w = 1.0 / np.sqrt(
        np.maximum(deg_u[edge_u], 1.0) * np.maximum(deg_i[edge_i], 1.0)
    )
    return edge_u, edge_i, w.astype(np.float32)


def build_dense_adjacency(user_consumed, n_users, n_items, u_rows, i_rows):
    """Dense symmetric-normalized adjacency (u_rows, i_rows) float32,
    zero-padded to the aligned table row counts: one propagation layer is
    then two dense products, ``A @ item_h`` and ``A.T @ user_h``."""
    eu, ei, w = build_edges(user_consumed, n_users, n_items)
    A = np.zeros((u_rows, i_rows), np.float32)
    A[eu, ei] = w
    return A


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
