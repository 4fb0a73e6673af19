"""ALS: alternating least squares matrix factorization.

Counterpart of ``librecommender_tpu/models/als.py``, with the same
constructor kwargs and parameter tree. Not trained by gradient steps: each
epoch solves the user side, then the item side, in batches. The rows of a
side are bucketed by their interaction count, padded to the next power of
two; a bucket gathers the other side's rows of its (B, L) ids through the
gather kernel (``ops/table_gather.table_gather``, the port of
``librecommender_tpu/ops/mxu_gather.py::_gather_kernel``: exact, so the
values are those of plain indexing), builds its (B, D, D) normal matrices
with einsums and solves them with ``torch.linalg.solve``. The explicit task
fits the observed labels; the implicit (``ranking``) task weighs them by the
Hu-Koren-Volinsky confidence ``1 + alpha * label`` and adds ``V^T V``.
``use_cg`` is accepted and ignored: every solve is a direct one.
"""
import numpy as np
import torch

from ..bases.embed_base import EmbedBase
from ..evaluation.evaluate import print_metrics
from ..ops.initializers import truncated_normal
from ..ops.table_gather import table_gather
from ..utils.misc import time_block
from ..utils.validate import check_fitting


def bucketize(consumed, labels_map, n_rows):
    """Group rows by their interaction count rounded up to a power of two:
    a list of (L, row ids (B,), padded ids (B, L), padded labels (B, L)),
    by ascending L; padding has id 0 and label 0."""
    buckets = {}
    for r in range(n_rows):
        n = len(consumed.get(r, []))
        if n:
            buckets.setdefault(1 << (n - 1).bit_length(), []).append(r)
    out = []
    for L, rows in sorted(buckets.items()):
        ids = np.zeros((len(rows), L), np.int32)
        ws = np.zeros((len(rows), L), np.float32)
        for j, r in enumerate(rows):
            items = np.asarray(consumed[r], dtype=np.int64)
            ids[j, : len(items)] = items
            ws[j, : len(items)] = labels_map(r, items)
        out.append((L, np.asarray(rows, np.int32), ids, ws))
    return out


class ALS(EmbedBase):
    def __init__(
        self,
        task,
        data_info,
        embed_size=16,
        n_epochs=10,
        reg=None,
        alpha=10,
        use_cg=True,  # accepted for API familiarity; solves are direct
        n_threads=1,
        seed=42,
        lower_upper_bound=None,
        device=None,
    ):
        # `device` stays out of all_args: the JAX package loads the saved
        # hyper-params as kwargs and has no such argument
        self.all_args = {
            k: v for k, v in locals().items()
            if k not in ("self", "__class__", "data_info", "device")
        }
        super().__init__(task, data_info, embed_size, lower_upper_bound, seed,
                         device)
        self.n_epochs = n_epochs
        self.reg = reg if reg is not None else 0.01
        self.alpha = alpha

    def _init_params(self, generator):
        return {
            "user_embed": truncated_normal(generator, (self.n_users, self.embed_size)),
            "item_embed": truncated_normal(generator, (self.n_items, self.embed_size)),
        }

    def loss_fn(self, params, batch):
        raise NotImplementedError("ALS trains by alternating solves")

    # --------------------------------------------------------------- solving
    def solve_bucket(self, other, ids, ws, VtV=None):
        """One bucket's rows: (B, L) ids into ``other`` and labels ->
        (B, D) solutions. ``VtV``: ``other.T @ other`` (implicit task)."""
        B, L = ids.shape
        D = other.shape[1]
        V = table_gather(other, ids.reshape(-1)).reshape(B, L, D)
        mask = (ws != 0.0).to(V.dtype)
        reg_eye = self.reg * torch.eye(D, device=other.device)
        if VtV is None:
            Vm = V * mask[:, :, None]
            A = torch.einsum("bld,ble->bde", Vm, Vm) + reg_eye
            b = torch.einsum("bld,bl->bd", Vm, ws)
        else:
            conf = float(self.alpha) * ws * mask                 # c - 1
            A = VtV + torch.einsum("bld,bl,ble->bde", V, conf, V) + reg_eye
            b = torch.einsum("bld,bl->bd", V, (1.0 + conf) * mask)
        return torch.linalg.solve(A, b[..., None])[..., 0]

    @torch.no_grad()
    def solve_side(self, own_key, other_key, buckets):
        """Solve every bucket of one side against the other side's table,
        which stays fixed meanwhile; the solutions go into ``own_key``."""
        own, other = self.net[own_key], self.net[other_key]
        VtV = other.T @ other if self.task == "ranking" else None
        for _, rows, ids, ws in buckets:
            out = self.solve_bucket(other, ids, ws, VtV)
            own.index_copy_(0, rows, out)

    def _device_buckets(self, buckets):
        return [(L, torch.from_numpy(rows).long().to(self.device),
                 torch.from_numpy(ids).to(self.device),
                 torch.from_numpy(ws).to(self.device))
                for L, rows, ids, ws in buckets]

    def side_buckets(self, train_data):
        """(user-side buckets, item-side buckets) of ``train_data``, on the
        device."""
        if self.task == "ranking":
            def user_label(u, items):
                return np.ones(len(items), np.float32)
            item_label = user_label
        else:
            by_user = train_data.sparse_interaction.tocsr()
            by_item = by_user.T.tocsr()

            def user_label(u, items):
                return np.asarray(by_user[u, items].todense()).ravel()

            def item_label(i, users):
                return np.asarray(by_item[i, users].todense()).ravel()
        info = self.data_info
        users = bucketize(info.user_consumed, user_label, self.n_users)
        items = bucketize(info.item_consumed, item_label, self.n_items)
        return self._device_buckets(users), self._device_buckets(items)

    def fit(
        self,
        train_data,
        neg_sampling,
        verbose=1,
        shuffle=True,
        eval_data=None,
        metrics=None,
        k=10,
        eval_batch_size=8192,
        eval_user_num=None,
        **kwargs,
    ):
        """Alternate ``n_epochs`` times: every user's row, then every item's.
        ``shuffle`` and the other fit options are accepted and unused."""
        check_fitting(self, train_data, eval_data, neg_sampling, k)
        if self.net is None:
            self.build_model()
        user_buckets, item_buckets = self.side_buckets(train_data)
        for epoch in range(1, self.n_epochs + 1):
            with time_block(f"Epoch {epoch}", verbose):
                self.solve_side("user_embed", "item_embed", user_buckets)
                self.solve_side("item_embed", "user_embed", item_buckets)
            if verbose > 1:
                self.set_embeddings()
                print_metrics(
                    self,
                    eval_data=eval_data,
                    metrics=metrics,
                    eval_batch_size=eval_batch_size,
                    k=k,
                    sample_user_num=eval_user_num,
                    seed=self.seed,
                    neg_sampling=neg_sampling,
                )
        self.post_fit()

    def set_embeddings(self):
        p = self.params_to_arrays()
        self._set_exported(self._append_oov(p["user_embed"]),
                           self._append_oov(p["item_embed"]))
