"""IVF approximate nearest-neighbour index, on the device.

Counterpart of ``librecommender_tpu/retrieval/ivf.py``: spherical k-means
over the item embeddings, padded inverted lists, and a two-stage
inner-product search (score the centroids, probe the top ``n_probe``
clusters, score their members exactly). Per query the search scores C
centroids and ``n_probe`` lists instead of all N items.

On a CUDA device every step runs on the card through the port's kernels:
- the cluster sums of a Lloyd iteration through the segment-sum
  (``ops/table_gather.segment_sum``, kernel 2.2b): each cluster's members
  added in ascending item order, so two builds from one seed are
  bit-identical;
- the probe through the streaming top-k (``ops/streaming_topk``, kernel
  2.1): top-``n_probe`` of ``queries @ centroids.T``, ties to the lower
  cluster, as ``jax.lax.top_k`` breaks them;
- the candidates' rows through the gather (``ops/table_gather.table_gather``,
  kernel 2.2a).
The (N, C) cosine product and the candidates' scores are float32 products
with TF32 off, whatever the caller's setting; the inverted lists come from a
stable sort of the assignment. On a CPU device the same code runs the
kernels' plain versions.

The initial centroids are ``torch.randperm(n)[:C]`` from a generator seeded
by ``seed``: the JAX package draws them with ``jax.random.choice``, which
the port does not reproduce. ``lloyd`` takes the initial indices, so that
both packages can start from one draw. An index saved by either package
(``ivf_index.npz`` and ``ivf_index_meta.json``) loads in the other.
"""
import json
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.nn import _matmul_float32, float32_matmul
from ..ops.streaming_topk import streaming_topk
from ..ops.table_gather import segment_sum, table_gather
from ..ops.topk import topk_from_scores

# A search scores its users' candidates in chunks of users whose gathered
# rows (users x n_probe x longest list x D float32) stay within this.
SEARCH_CHUNK_BYTES = 1 << 30


def normalize_rows(x):
    """Rows divided by ``max(norm, 1e-8)``."""
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-8)


def assign_clusters(normed, centroids):
    """Each row's cluster: the argmax of its cosine to the centroids, ties to
    the lower cluster (``torch.argmax`` returns the first maximum)."""
    return torch.argmax(float32_matmul(normed, centroids.T), dim=1)


def update_centroids(normed, centroids, assign):
    """One Lloyd update from an assignment: each cluster's mean of its
    members (their sum through the segment-sum kernel), an empty cluster
    keeping its old centroid, then renormalized. Returns (centroids, sums,
    counts)."""
    n_clusters = centroids.shape[0]
    sums = segment_sum(assign, normed, n_clusters)
    counts = torch.bincount(assign, minlength=n_clusters)[:, None].to(normed.dtype)
    new = torch.where(counts > 0, sums / counts.clamp_min(1.0), centroids)
    return normalize_rows(new), sums, counts


def lloyd(vectors, init_idx, iters):
    """Spherical k-means from the rows ``init_idx`` of the normalized
    vectors: ``iters`` Lloyd steps, then the final assignment. ``vectors``
    (N, D) float32 tensor; returns (centroids (C, D), assign (N,) int64) on
    its device."""
    normed = normalize_rows(vectors)
    if not isinstance(init_idx, torch.Tensor):
        init_idx = torch.from_numpy(np.array(init_idx, np.int64))
    centroids = normed[init_idx.to(normed.device).long()]
    for _ in range(iters):
        centroids, _, _ = update_centroids(
            normed, centroids, assign_clusters(normed, centroids))
    return centroids, assign_clusters(normed, centroids)


def initial_indices(n, n_clusters, seed):
    """The initial centroids' rows: ``randperm(n)[:n_clusters]`` from a CPU
    generator seeded by ``seed`` (the same rows on every device)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=gen)[:n_clusters]


def inverted_lists(assign, n_clusters):
    """(lists (C, L) int32, counts (C,) int64): each cluster's members in
    ascending item id, padded with -1 to the longest list ``L`` (one row of
    -1 when there are no items), by a stable sort of the assignment."""
    counts = torch.bincount(assign, minlength=n_clusters)
    n = assign.shape[0]
    longest = int(counts.max()) if n else 1
    lists = torch.full((n_clusters, longest), -1, dtype=torch.int32,
                       device=assign.device)
    if n:
        order = torch.sort(assign, stable=True).indices
        cluster = assign[order]
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(n, device=assign.device) - starts[cluster]
        lists[cluster, slot] = order.to(torch.int32)
    return lists, counts


class IVFIndex:
    """Inverted-file index over item embeddings (inner-product search)."""

    def __init__(self, item_embeds, centroids, lists, counts, device=None):
        self.device = resolve_device(device)

        def on_device(x, dtype):
            if isinstance(x, torch.Tensor):
                return x.to(self.device, dtype).contiguous()
            return torch.from_numpy(np.array(x)).to(self.device, dtype)

        self.item_embeds = on_device(item_embeds, torch.float32)
        self.centroids = on_device(centroids, torch.float32)
        self.lists = on_device(lists, torch.int32)        # (C, L) padded with -1
        self.counts = on_device(counts, torch.int64)
        self.n_items = int(self.item_embeds.shape[0])

    @classmethod
    def build(cls, item_embeds, n_clusters=None, iters=20, seed=0, device=None):
        device = resolve_device(device)
        if not isinstance(item_embeds, torch.Tensor):
            item_embeds = torch.from_numpy(np.array(item_embeds, np.float32))
        items = item_embeds.to(device, torch.float32).contiguous()
        n = items.shape[0]
        if n_clusters is None:
            n_clusters = max(4, int(np.sqrt(n)))
        n_clusters = min(n_clusters, n)
        centroids, assign = lloyd(items, initial_indices(n, n_clusters, seed),
                                  iters)
        lists, counts = inverted_lists(assign, n_clusters)
        return cls(items, centroids, lists, counts, device=device)

    def search(self, queries, k, n_probe=8):
        """(U, D) queries (numpy or a tensor) -> (ids (U, k) int32, scores
        (U, k) float32) as numpy; approximate. Rows are padded with -1 and
        -inf where ``k`` passes the probed candidates."""
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().to(self.device, torch.float32)
        else:
            queries = torch.from_numpy(
                np.array(queries, np.float32)).to(self.device)
        queries = torch.atleast_2d(queries).contiguous()
        n_probe = min(int(n_probe), self.centroids.shape[0])
        row_bytes = n_probe * self.lists.shape[1] * self.item_embeds.shape[1] * 4
        step = max(1, SEARCH_CHUNK_BYTES // row_bytes)
        parts = [self._search(q, int(k), n_probe) for q in queries.split(step)]
        ids = torch.cat([p[0] for p in parts])
        scores = torch.cat([p[1] for p in parts])
        return ids.cpu().numpy(), scores.cpu().numpy()

    def _search(self, queries, k, n_probe):
        U, D = queries.shape
        top_c, _ = streaming_topk(queries, self.centroids, n_probe)   # (U, P)
        members = self.lists[top_c.long()].reshape(U, -1)             # (U, P*L)
        cand = table_gather(self.item_embeds, members.reshape(-1))
        with _matmul_float32():
            scores = torch.bmm(cand.view(U, -1, D), queries[:, :, None])[..., 0]
        scores = torch.where(members >= 0, scores, float("-inf"))
        kk = min(k, scores.shape[1])
        pos, top_scores = topk_from_scores(scores, None, kk)
        top_ids = torch.gather(members, 1, pos)
        if kk < k:   # fewer candidates than k: pad to k
            top_ids = torch.cat([top_ids, top_ids.new_full((U, k - kk), -1)], 1)
            top_scores = torch.cat(
                [top_scores, top_scores.new_full((U, k - kk), float("-inf"))], 1)
        return top_ids, top_scores

    # --------------------------------------------------------- persistence
    def save(self, path, name="ivf_index"):
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path / name,
            item_embeds=self.item_embeds.cpu().numpy(),
            centroids=self.centroids.cpu().numpy(),
            lists=self.lists.cpu().numpy(),
            counts=self.counts.cpu().numpy(),
        )
        with open(path / f"{name}_meta.json", "w") as f:
            json.dump(
                {"n_items": self.n_items,
                 "n_clusters": int(self.centroids.shape[0])}, f,
            )

    @classmethod
    def load(cls, path, name="ivf_index", device=None):
        with np.load(Path(path) / f"{name}.npz") as arrays:
            return cls(arrays["item_embeds"], arrays["centroids"],
                       arrays["lists"], arrays["counts"], device=device)
