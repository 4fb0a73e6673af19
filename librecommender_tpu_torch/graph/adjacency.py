"""Graph structures built once on the host.

Counterpart of ``build_edges``, ``build_dense_adjacency`` and
``build_neighbor_table`` in ``librecommender_tpu/graph/adjacency.py``, copied
as they are (the same seed, so the same subsets): edge lists with symmetric
normalised weights and the dense padded adjacency for full-graph propagation
(LightGCN, NGCF), fixed-width neighbour tables (GraphSage), and PinSage's
importance-weighted walk neighbourhoods.
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


def pinsage_neighbor_table(
    user_consumed,
    item_consumed,
    n_items,
    num_walks=10,
    walk_len=2,
    top_t=10,
    termination_prob=0.5,
    seed=0,
):
    """Importance-weighted item-item neighborhoods via bipartite random walks
    (item -> user -> item), PinSage style: each item's top-T most-visited
    items with visit-count weights, ties in first-visit order.

    Returns (neighbors (n_items, T) padded with n_items, weights (n_items, T)).
    """
    rng = np.random.default_rng(seed)
    neighbors = np.full((n_items, top_t), n_items, dtype=np.int32)
    weights = np.zeros((n_items, top_t), dtype=np.float32)
    item_users = {
        int(i): np.asarray(us, dtype=np.int64) for i, us in item_consumed.items()
    }
    user_items = {
        int(u): np.asarray(its, dtype=np.int64) for u, its in user_consumed.items()
    }
    for i in range(n_items):
        counts = {}
        for _ in range(num_walks):
            cur = i
            for _ in range(walk_len):
                us = item_users.get(cur)
                if us is None or us.size == 0:
                    break
                u = int(us[rng.integers(us.size)])
                its = user_items.get(u)
                if its is None or its.size == 0:
                    break
                cur = int(its[rng.integers(its.size)])
                if cur != i:
                    counts[cur] = counts.get(cur, 0) + 1
                if rng.random() < termination_prob:
                    break
        if counts:
            top = sorted(counts.items(), key=lambda kv: -kv[1])[:top_t]
            total = sum(c for _, c in top)
            for j, (it, c) in enumerate(top):
                neighbors[i, j] = it
                weights[i, j] = c / total
    return neighbors, weights
