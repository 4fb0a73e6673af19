"""Top-k similar rows of a sparse matrix, on the device: cosine, pearson and
jaccard.

Counterpart of ``librecommender_tpu/utils/similarities.py`` and of the host
C++ it calls (``csr_preprocess_transpose``, ``topk_similarities`` and
``update_topk_similarities`` in ``librecommender_tpu/native/
similarities.cpp``). The C++ walks each row's touched neighbours through an
inverted index; here a block of rows is multiplied against the whole
normalised matrix, one product for the values and one of the 0/1 indicators
for the common counts (float32, exact below 2^24), whatever the caller's TF32
setting is. The values' product takes the float32 rows in float64 and rounds
its sums to float32: a float32 product's own rounding over an item's
thousands of users reaches 1e-5 relative, and differs between the card's and
the CPU's summation orders, where the float64 sums agree to float32 rounding.
The matrices stay dense where they fit in ``SCRATCH_BYTES``, else the
products are sparse; the blocks are sized so that their scratch stays under
it.

Kept from the C++ exactly:

- the preprocessing: pearson's row mean is summed in float64, the row norm is
  the square root of a float64 sum, its inverse ``1 / max(norm, 1e-10)`` is
  float32, and jaccard reads 1.0 for every stored entry;
- a candidate is a row that shares at least ``max(min_common, 1)``
  dimensions with the query, the query itself excluded; a candidate whose
  similarity is exactly 0.0 is kept;
- jaccard is ``common / (nnz_x + nnz_y - common)`` in float32, 0 where the
  denominator is not positive;
- neighbours are ordered by similarity, then by lower id, and rows are padded
  with -1 / 0.0 to width k;
- the incremental update (see :func:`update_topk_similarities`).

The C++ adds its float32 products in sequence, in float32, so values agree
with its within its rounding and ids agree except between near-equal
similarities.
"""
import numpy as np
import torch

from ..ops.nn import _matmul_float32

SIM_TYPES = ("cosine", "pearson", "jaccard")

#: bytes of scratch a search may hold at once (its dense matrices and one
#: block's products and sort)
SCRATCH_BYTES = 2 << 30

# the C++'s "no minimum" for an untouched row's old list
_NO_MIN = float(np.float32(-3.0e38))


def fast_transpose(csr):
    """The CSR of ``csr.T``; each transposed row lists its entries by
    ascending original row (the order of the C++'s counting-sort
    transpose)."""
    return csr.T.tocsr()


def _csr_tensors(csr, device):
    csr = csr.tocsr()
    indptr = torch.as_tensor(np.asarray(csr.indptr, np.int64), device=device)
    indices = torch.as_tensor(np.asarray(csr.indices, np.int64), device=device)
    data = torch.as_tensor(np.asarray(csr.data, np.float32), device=device)
    return indptr, indices, data


def _row_ids(indptr):
    lengths = indptr[1:] - indptr[:-1]
    return torch.repeat_interleave(
        torch.arange(len(lengths), device=indptr.device), lengths)


def _row_sums64(values, indptr):
    """Per-row float64 sums of ``values`` (one entry per stored element), in
    a fixed order: each block of rows is laid out dense, padded with zeros,
    and summed along its rows, so that two runs give the same bits."""
    n = indptr.shape[0] - 1
    out = torch.zeros(n, dtype=torch.float64, device=values.device)
    if n == 0 or values.numel() == 0:
        return out
    lengths = indptr[1:] - indptr[:-1]
    width = max(int(lengths.max()), 1)
    block = max(1, SCRATCH_BYTES // (8 * width))
    for s in range(0, n, block):
        e = min(s + block, n)
        lo, hi = int(indptr[s]), int(indptr[e])
        rows = _row_ids(indptr[s:e + 1] - lo)
        pos = torch.arange(hi - lo, device=values.device) - (indptr[s:e] - lo)[rows]
        dense = torch.zeros(e - s, width, dtype=torch.float64, device=values.device)
        dense[rows, pos] = values[lo:hi]
        out[s:e] = dense.sum(dim=1)
    return out


def preprocess(csr, kind, device):
    """(indptr, indices, normalised data, nnz per row as float32) of the
    rows of ``csr`` on ``device``, as ``csr_preprocess_transpose`` makes
    them: cosine and pearson rows scaled to unit norm (pearson's centred on
    their mean first), jaccard's entries 1.0."""
    if kind not in SIM_TYPES:
        raise ValueError(f"unknown sim_type: {kind}")
    indptr, indices, data = _csr_tensors(csr, device)
    nnz = (indptr[1:] - indptr[:-1]).to(torch.float32)
    if kind == "jaccard":
        return indptr, indices, torch.ones_like(data), nnz
    rows = _row_ids(indptr)
    if kind == "pearson":
        counts = (indptr[1:] - indptr[:-1]).clamp(min=1).to(torch.float64)
        mean = (_row_sums64(data.double(), indptr) / counts).to(torch.float32)
        data = data - mean[rows]
    sq = _row_sums64(data.double() * data.double(), indptr)
    norm = torch.sqrt(sq).to(torch.float32)
    inv = 1.0 / torch.clamp(norm, min=1e-10)
    return indptr, indices, data * inv[rows], nnz


class _Rows:
    """The normalised rows (float64 copies of the float32 values) and their
    indicators, dense where both fit in a quarter of ``SCRATCH_BYTES``, else
    sparse CSR; ``products(s, e)`` gives the values (float64 sums rounded to
    float32) and common counts of rows [s, e) against all rows."""

    def __init__(self, indptr, indices, data, n_cols, values=True):
        self.n = indptr.shape[0] - 1
        self.device = data.device
        self.values = values   # jaccard reads only the common counts
        data = data.double()
        self.dense = 12 * self.n * max(n_cols, 1) <= SCRATCH_BYTES // 4
        if self.dense:
            rows = _row_ids(indptr)
            self.x = torch.zeros(self.n, n_cols, dtype=torch.float64,
                                 device=self.device)
            self.x.index_put_((rows, indices), data, accumulate=True)
            self.b = torch.zeros(self.n, n_cols, device=self.device)
            self.b.index_put_((rows, indices), torch.ones_like(data, dtype=torch.float32),
                              accumulate=True)
            self.xt, self.bt = self.x.T, self.b.T
        else:
            self.parts = (indptr, indices, data, n_cols)
            shape = (self.n, n_cols)
            x = torch.sparse_csr_tensor(indptr, indices, data, shape,
                                        check_invariants=False)
            b = torch.sparse_csr_tensor(indptr, indices,
                                        torch.ones_like(data, dtype=torch.float32),
                                        shape, check_invariants=False)
            self.xt = x.to_sparse_coo().t().to_sparse_csr()
            self.bt = b.to_sparse_coo().t().to_sparse_csr()

    def _block(self, s, e, values):
        indptr, indices, data, n_cols = self.parts
        lo, hi = int(indptr[s]), int(indptr[e])
        vals = (data[lo:hi] if values
                else torch.ones_like(data[lo:hi], dtype=torch.float32))
        return torch.sparse_csr_tensor(indptr[s:e + 1] - lo, indices[lo:hi],
                                       vals, (e - s, n_cols), check_invariants=False)

    def products(self, s, e):
        with _matmul_float32():
            if self.dense:
                vals = (self.x[s:e] @ self.xt).to(torch.float32) if self.values else None
                return vals, self.b[s:e] @ self.bt
            vals = ((self._block(s, e, True) @ self.xt).to_dense().to(torch.float32)
                    if self.values else None)
            return vals, (self._block(s, e, False) @ self.bt).to_dense()

    def products_of(self, rows):
        """Products of the rows ``rows`` (a 1-D id tensor) against all."""
        with _matmul_float32():
            if self.dense:
                vals = (self.x[rows] @ self.xt).to(torch.float32) if self.values else None
                return vals, self.b[rows] @ self.bt
        vals, common = zip(*(self.products(int(r), int(r) + 1) for r in rows))
        return None if vals[0] is None else torch.cat(vals), torch.cat(common)


def _scores(vals, common, query_rows, nnz, min_common, jaccard):
    """The block's similarities, -inf where not a candidate."""
    if jaccard:
        denom = nnz[query_rows][:, None] + nnz[None, :] - common
        sims = torch.where(denom > 0, common / denom, torch.zeros_like(common))
    else:
        sims = vals
    cand = common >= max(int(min_common), 1)
    cand[torch.arange(len(query_rows), device=cand.device), query_rows] = False
    return torch.where(cand, sims, torch.full_like(sims, -torch.inf)), cand


def _ordered(keys, ids, k):
    """The first k of each row by key descending, then id ascending:
    (keys, positions). ``keys`` are never -0.0 (see ``_sortable``)."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    keys_by_id = torch.gather(keys, 1, by_id)
    order = torch.argsort(keys_by_id, dim=1, descending=True, stable=True)[:, :k]
    pos = torch.gather(by_id, 1, order)
    return torch.gather(keys, 1, pos), pos


def _sortable(x):
    # x + 0.0 turns -0.0 into +0.0: a radix sort on the bits would put -0.0
    # below +0.0, where the C++ comparison holds them equal
    return x + 0.0


def _topk_rows(sims, k):
    """(ids, values, valid) of each row's k best, by similarity then lower
    column; the columns are ids in ascending order, so a stable sort
    suffices."""
    take = min(k, sims.shape[1])
    order = torch.argsort(_sortable(sims), dim=1, descending=True, stable=True)[:, :take]
    vals = torch.gather(sims, 1, order)
    valid = torch.isfinite(vals)
    return order, vals, valid


def _write(out_ids, out_sims, rows, order, vals, valid):
    take = order.shape[1]
    out_ids[rows, :take] = torch.where(valid, order, -1).to(torch.int32)
    out_sims[rows, :take] = torch.where(valid, vals, torch.zeros_like(vals))


def _block_rows(n):
    # per query row: float64 sums, float32 values, common counts, scores and
    # sort keys, an int64 order and a mask, against all n rows
    return max(1, SCRATCH_BYTES // (40 * max(n, 1)))


def topk_similarities(interaction, kind, k, min_common=1, n_threads=0,
                      device="cpu"):
    """interaction: scipy CSR (n_rows, n_dims); its rows are the entities
    compared. Returns numpy (ids (n_rows, k) int32 padded with -1, sims
    (n_rows, k) float32 padded with 0). ``n_threads`` is accepted and
    ignored (the host C++'s thread count)."""
    if kind not in SIM_TYPES:
        raise ValueError(f"unknown sim_type: {kind}")
    device = torch.device(device)
    indptr, indices, data, nnz = preprocess(interaction, kind, device)
    n = indptr.shape[0] - 1
    x = _Rows(indptr, indices, data, interaction.shape[1], values=kind != "jaccard")
    out_ids = torch.full((n, k), -1, dtype=torch.int32, device=device)
    out_sims = torch.zeros((n, k), dtype=torch.float32, device=device)
    block = _block_rows(n)
    for s in range(0, n, block):
        e = min(s + block, n)
        vals, common = x.products(s, e)
        rows = torch.arange(s, e, device=device)
        sims, _ = _scores(vals, common, rows, nnz, min_common, kind == "jaccard")
        _write(out_ids, out_sims, rows, *_topk_rows(sims, k))
    return out_ids.cpu().numpy(), out_sims.cpu().numpy()


def update_topk_similarities(old_ids, old_sims, merged, touched, kind, k,
                             min_common=1, n_threads=0, device="cpu"):
    """Update top-k neighbour lists after new interactions, as the C++
    ``update_topk_similarities`` does.

    ``merged`` is the whole (old + new) interaction CSR, ``touched`` the rows
    with new interactions. Touched rows are searched afresh against the
    merged data. An untouched row keeps its old list, with every entry that
    names a touched row replaced by its fresh similarity, merged with the
    fresh candidates from touched rows; a fresh candidate enters only where
    its similarity beats the old list's last (a full list naming no touched
    row) and otherwise only if the list is not full, so that a pair evicted
    from a list in an earlier round cannot re-enter. An untouched row with no
    fresh candidate and no stale entry is copied through. Old lists may have
    fewer rows than the merged data (vocabulary growth); a changed ``k``
    raises. Returns numpy (ids, sims) over the merged rows.
    """
    if kind not in SIM_TYPES:
        raise ValueError(f"unknown sim_type: {kind}")
    if old_ids.shape[1] != k:
        raise ValueError(
            f"k_sim changed between fits ({old_ids.shape[1]} -> {k}); "
            "incremental update requires the same k"
        )
    device = torch.device(device)
    indptr, indices, data, nnz = preprocess(merged, kind, device)
    n = indptr.shape[0] - 1
    n_old = old_ids.shape[0]
    x = _Rows(indptr, indices, data, merged.shape[1], values=kind != "jaccard")
    touched = torch.as_tensor(np.unique(np.asarray(touched, np.int64)), device=device)
    is_touched = torch.zeros(n, dtype=torch.bool, device=device)
    is_touched[touched] = True
    old_ids_t = torch.as_tensor(np.asarray(old_ids, np.int64), device=device)
    old_sims_t = torch.as_tensor(np.asarray(old_sims, np.float32), device=device)

    # an untouched row's pruning state: its old list up to the first -1,
    # whether that names a touched row, and the least similarity a fresh
    # candidate must beat (only for a full list naming no touched row)
    listed = torch.cumprod((old_ids_t >= 0).to(torch.int64), dim=1).bool()
    names_touched = listed & is_touched[old_ids_t.clamp(min=0)]
    refers = names_touched.any(dim=1)
    full = listed.sum(dim=1) == k
    old_min = torch.full((n,), _NO_MIN, device=device)
    old_min[:n_old] = torch.where(full & ~refers, old_sims_t[:, k - 1],
                                  torch.full_like(old_sims_t[:, k - 1], _NO_MIN))
    eligible = ~is_touched
    eligible[n_old:] = False

    out_ids = torch.full((n, k), -1, dtype=torch.int32, device=device)
    out_sims = torch.zeros((n, k), dtype=torch.float32, device=device)
    # each untouched old row's best k fresh candidates so far; touched rows
    # go in ascending order, so on ties the earlier (lower) id stays first
    fresh_vals = torch.full((n_old, k), -torch.inf, device=device)
    fresh_ids = torch.full((n_old, k), -1, dtype=torch.int64, device=device)
    has_fresh = torch.zeros(n_old, dtype=torch.bool, device=device)
    block = _block_rows(n)
    for s in range(0, len(touched), block):
        rows = touched[s:s + block]
        vals, common = x.products_of(rows)
        sims, cand = _scores(vals, common, rows, nnz, min_common, kind == "jaccard")
        _write(out_ids, out_sims, rows, *_topk_rows(sims, k))
        enter = cand & eligible[None, :] & (sims > old_min[None, :])
        enter = enter[:, :n_old].T                             # (n_old, b)
        has_fresh |= enter.any(dim=1)
        cand_vals = torch.where(enter, sims[:, :n_old].T,
                                torch.full_like(enter, -torch.inf, dtype=torch.float32))
        both_vals = torch.cat([fresh_vals, cand_vals], dim=1)
        both_ids = torch.cat([fresh_ids, rows[None, :].expand(n_old, -1)], dim=1)
        order = torch.argsort(_sortable(both_vals), dim=1, descending=True,
                              stable=True)[:, :k]
        fresh_vals = torch.gather(both_vals, 1, order)
        fresh_ids = torch.gather(both_ids, 1, order)

    # untouched old rows: the old entries naming untouched rows, merged with
    # the fresh candidates, by similarity then lower id
    kept = listed & ~names_touched
    merged_vals = torch.cat([torch.where(kept, old_sims_t, -torch.inf), fresh_vals], 1)
    merged_ids = torch.cat([torch.where(kept, old_ids_t, -1), fresh_ids], 1)
    sort_ids = torch.where(torch.isfinite(merged_vals), merged_ids, n)
    keys, pos = _ordered(_sortable(merged_vals), sort_ids, k)
    valid = torch.isfinite(keys)
    new_ids = torch.where(valid, torch.gather(merged_ids, 1, pos), -1).to(torch.int32)
    new_sims = torch.where(valid, torch.gather(merged_vals, 1, pos),
                           torch.zeros_like(keys))
    copy = ~has_fresh & ~refers
    old_rows = torch.nonzero(eligible[:n_old]).squeeze(1)
    keep_old = copy[old_rows][:, None]
    out_ids[old_rows] = torch.where(keep_old, old_ids_t[old_rows].to(torch.int32),
                                    new_ids[old_rows])
    out_sims[old_rows] = torch.where(keep_old, old_sims_t[old_rows],
                                     new_sims[old_rows])
    return out_ids.cpu().numpy(), out_sims.cpu().numpy()
