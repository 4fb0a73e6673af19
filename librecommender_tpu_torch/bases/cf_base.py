"""Neighbourhood collaborative filtering (UserCF, ItemCF, Swing), on the
device.

Counterpart of ``librecommender_tpu/bases/cf_base.py``. The top-k neighbour
lists come from ``utils/similarities.py`` (Swing's from ``ops/swing.py``);
``predict`` and ``recommend_user`` keep the semantics of ``cf_predict`` and
``cf_recommend`` in ``librecommender_tpu/native/similarities.cpp``, which the
JAX package serves through:

- ``predict``: float64 sums over the query side's neighbours whose
  interaction with the other side is stored and non-zero; the rating is
  ``num / max(sum |s|, 1e-10)`` over those, the ranking score the share of
  the neighbours' similarity mass they carry; unknown ids and pairs with no
  rated neighbour get the default prediction; ratings are clipped.
- ``recommend_user``: each user's scores add up in float64 in the C++'s
  order (UserCF: neighbour by neighbour, each neighbour's row; ItemCF and
  Swing: consumed item by consumed item in the interaction row's order, each
  item's neighbour list), so the sums are the C++'s bits: the terms of all
  the batch's users go in rounds, the r-th term of every item's sum in round
  r, as many rounds as the longest sum has terms; an item whose sum
  is exactly 0 is no candidate; consumed items are filtered unless the
  remainder cannot fill ``n_rec`` (then the user's list goes unfiltered);
  the order is by the sum rounded to float32, then by lower id; a short list
  is filled from the popular items (not consumed-filtered, no duplicates),
  and cold users get the popular items.

Both run on ``self.device`` over tensors uploaded once after a fit or load;
``recommend_user`` takes the users in batches whose (users, n_items) float64
scratch stays under ``SCRATCH_BYTES``. ``save`` / ``load`` use the JAX
package's ``{name}_cf.npz`` layout, so either package loads the other's.
"""
from pathlib import Path

import numpy as np
import torch
from scipy.sparse import csr_matrix

from .base import Base
from ..recommendation.cold_start import popular_recommendations
from ..utils.misc import colorize, time_block
from ..utils.save_load import (
    load_default_recs,
    load_hyper_params,
    save_default_recs,
    save_hyper_params,
)
from ..utils.similarities import (
    SIM_TYPES,
    fast_transpose,
    topk_similarities,
    update_topk_similarities,
)
from ..utils.validate import check_fitting

#: bytes of scores and their sort ``recommend_user`` holds at once
SCRATCH_BYTES = 1 << 30


class CfBase(Base):
    cf_mode = None  # "user" or "item"

    def __init__(
        self,
        task,
        data_info,
        sim_type="cosine",
        k_sim=20,
        store_top_k=True,
        num_threads=0,
        min_common=1,
        mode=None,  # accepted for API familiarity (invert/forward); ignored
        seed=42,
        lower_upper_bound=None,
        device=None,
    ):
        super().__init__(task, data_info, lower_upper_bound, seed, device)
        if sim_type not in SIM_TYPES:
            raise ValueError(f"unknown sim_type: {sim_type}")
        self.sim_type = sim_type
        self.k_sim = k_sim
        self.num_threads = num_threads
        self.min_common = min_common
        self.sim_ids = None        # (n_rows, k_sim) int32, padded with -1
        self.sim_vals = None       # (n_rows, k_sim) float32, padded with 0
        self.interaction = None    # user-item CSR
        self._old_cf_state = None  # set by rebuild_model for an incremental fit
        self._device_state = None

    def build_model(self):
        pass

    def loss_fn(self, params, batch):  # pragma: no cover
        raise NotImplementedError("CF models have no SGD loss")

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
        """Search the neighbours on ``self.device``. After ``rebuild_model``
        the saved interactions are merged with this data and only the
        neighbour lists the new rows touch are updated."""
        check_fitting(self, train_data, eval_data, neg_sampling, k)
        mat = train_data.sparse_interaction
        batch = csr_matrix(
            (mat.data, mat.indices, mat.indptr),
            shape=(self.n_users, self.n_items),
        )
        if self._old_cf_state is not None:
            old_ids, old_sims, old_inter = self._old_cf_state
            self._old_cf_state = None
            old_pad = old_inter.copy()
            old_pad.resize(self.n_users, self.n_items)  # vocabulary growth
            self.interaction = (old_pad + batch).tocsr()
            touched = np.unique(np.asarray(
                train_data.user_indices if self.cf_mode == "user"
                else train_data.item_indices))
            with time_block(f"update {self.sim_type} sims", verbose):
                self.sim_ids, self.sim_vals = update_topk_similarities(
                    old_ids, old_sims, self._entity(), touched, self.sim_type,
                    self.k_sim, self.min_common, device=self.device,
                )
        else:
            self.interaction = batch
            with time_block(f"{self.sim_type} sims", verbose):
                self.sim_ids, self.sim_vals = topk_similarities(
                    self._entity(), self.sim_type, self.k_sim, self.min_common,
                    device=self.device,
                )
        self._report(verbose)
        self.post_fit()
        self._print_eval(verbose, eval_data, metrics, eval_batch_size, k,
                         eval_user_num, neg_sampling)

    def _entity(self):
        """The rows the search compares: users, or items (the transpose)."""
        return (self.interaction if self.cf_mode == "user"
                else fast_transpose(self.interaction))

    def _report(self, verbose):
        if verbose > 0:
            n_with = int(np.sum(self.sim_ids[:, 0] >= 0))
            print(colorize(
                f"{n_with} of {self.sim_ids.shape[0]} {self.cf_mode}s have "
                "similar neighbors", "cyan"))

    def _print_eval(self, verbose, eval_data, metrics, eval_batch_size, k,
                    eval_user_num, neg_sampling):
        if verbose > 1 and eval_data is not None:
            from ..evaluation.evaluate import print_metrics

            print_metrics(
                self, eval_data=eval_data, metrics=metrics,
                eval_batch_size=eval_batch_size, k=k,
                sample_user_num=eval_user_num, seed=self.seed,
                neg_sampling=neg_sampling,
            )

    def post_fit(self):
        self._device_state = None
        self.build_default_recs()

    def _default_rec_source(self, num):
        return np.asarray(
            [self.data_info.item2id[i] for i in self.data_info.popular_items[:num]]
        )

    @property
    def default_pred(self):
        return self.global_mean if self.task == "rating" else 0.0

    def set_cf_state(self, sim_ids, sim_vals, interaction):
        """Take neighbour lists and the interaction CSR (either package's,
        e.g. from ``convert.cf_state_from_jax``) as this model's fitted
        state."""
        self.sim_ids = np.ascontiguousarray(sim_ids, np.int32)
        self.sim_vals = np.ascontiguousarray(sim_vals, np.float32)
        self.interaction = csr_matrix(interaction, shape=(self.n_users, self.n_items))
        self._device_state = None

    # ------------------------------------------------------------- inference
    def _state(self):
        """The neighbour lists and the interaction CSR (sorted rows) on the
        device, and the CSR's sorted (row * n_items + col) keys."""
        if self._device_state is None:
            inter = self.interaction.tocsr().copy()
            inter.sort_indices()
            dev = self.device

            def put(a, dtype):
                return torch.as_tensor(np.asarray(a, dtype), device=dev)

            indptr = put(inter.indptr, np.int64)
            indices = put(inter.indices, np.int64)
            rows = torch.repeat_interleave(
                torch.arange(inter.shape[0], device=dev), indptr[1:] - indptr[:-1])
            self._device_state = dict(
                ids=put(self.sim_ids, np.int64), vals=put(self.sim_vals, np.float32),
                indptr=indptr, indices=indices, data=put(inter.data, np.float32),
                keys=rows * self.n_items + indices,
            )
        return self._device_state

    def predict(self, user, item, inner_id=False, cold_start="average"):
        users, items = self.convert_ids(user, item, inner_id)
        st = self._state()
        dev = self.device
        u = torch.as_tensor(users, device=dev)
        i = torch.as_tensor(items, device=dev)
        known = (u < self.n_users) & (i < self.n_items)
        u_c = u.clamp(max=self.n_users - 1)
        i_c = i.clamp(max=self.n_items - 1)
        center = u_c if self.cf_mode == "user" else i_c
        nb, s = st["ids"][center], st["vals"][center]          # (P, k)
        listed = nb >= 0
        nb_c = nb.clamp(min=0)
        # the stored label of (neighbour, item) or (user, neighbour)
        keys = (nb_c * self.n_items + i_c[:, None] if self.cf_mode == "user"
                else u_c[:, None] * self.n_items + nb_c)
        if st["keys"].numel():
            pos = torch.searchsorted(st["keys"], keys).clamp(max=st["keys"].numel() - 1)
            found = listed & (st["keys"][pos] == keys)
            r = torch.where(found, st["data"][pos], 0.0)
        else:   # no stored interaction
            found, r = torch.zeros_like(listed), torch.zeros_like(s)
        rated = found & (r != 0)
        s64 = s.double()
        zero = torch.zeros_like(s64)
        num = torch.where(rated, s64 * r.double(), zero).sum(dim=1)
        den_abs = torch.where(rated, s64.abs(), zero).sum(dim=1)
        rated_signed = torch.where(rated, s64, zero).sum(dim=1)
        sim_mass = torch.where(listed, s64.abs(), zero).sum(dim=1)
        out = (num / den_abs.clamp(min=1e-10) if self.task == "rating"
               else rated_signed / sim_mass.clamp(min=1e-10))
        ok = known & listed.any(dim=1) & rated.any(dim=1)
        out = torch.where(ok, out, float(self.default_pred)).to(torch.float32)
        preds = out.cpu().numpy().astype(np.float64)
        if self.task == "rating":
            preds = np.clip(preds, self.lower_bound, self.upper_bound)
        return preds[0] if preds.size == 1 else preds

    def recommend_user(
        self,
        user,
        n_rec,
        inner_id=False,
        cold_start="average",
        filter_consumed=True,
        random_rec=False,
    ):
        raw_users = np.atleast_1d(np.asarray(user))
        if cold_start not in ("average", "popular"):
            raise ValueError(f"Unknown cold start strategy: {cold_start}")
        uids, keys = [], []
        for u in raw_users:
            uids.append(
                int(u) if inner_id and 0 <= int(u) < self.n_users
                else self.data_info.user2id.get(u, -1) if not inner_id
                else -1
            )
            keys.append(u.item() if isinstance(u, np.generic) else u)
        pops = np.asarray(
            popular_recommendations(self.data_info, inner_id=True, n_rec=n_rec),
            np.int64,
        )
        result = {}
        warm = [(q, uid) for q, uid in enumerate(uids) if uid >= 0]

        # users whose unconsumed remainder cannot fill n_rec recommend
        # unfiltered (the JAX package's can't-filter pass-through)
        def filtered(uid):
            return filter_consumed and (
                n_rec + len(self.user_consumed.get(uid, ())) <= self.n_items)

        for eff in (True, False):
            group = [(q, uid) for q, uid in warm if filtered(uid) == eff]
            if not group:
                continue
            qs, warm_uids = zip(*group)
            recs = self._recommend_ids(np.asarray(warm_uids, np.int64), n_rec,
                                       eff, pops)
            for q, row in zip(qs, recs):
                result[keys[q]] = row
        for q, uid in enumerate(uids):
            if uid < 0:
                result[keys[q]] = pops
        return self.finalize_rec(result, raw_users, inner_id)

    def _recommend_ids(self, uids, n_rec, filter_consumed, pops):
        """Each user's recommendations (inner ids, int64), in order."""
        out = []
        for block in self._blocks(uids):
            ids, n_valid = self._recommend_block(block, n_rec, filter_consumed)
            for row, n in zip(ids, n_valid):
                recs = list(row[:n])
                seen = set(recs)
                for p in pops:   # the popular fill
                    if len(recs) >= n_rec:
                        break
                    if int(p) not in seen:
                        recs.append(int(p))
                        seen.add(int(p))
                out.append(np.asarray(recs, np.int64))
        return out

    def _blocks(self, uids):
        """The users in consecutive blocks whose scratch stays under
        ``SCRATCH_BYTES``: per score a float64 sum, its float32 copy and
        key, a mask and an int64 order (32 bytes); per term of a sum its key,
        value, orders and rank (48 bytes)."""
        lengths = np.diff(self.interaction.indptr)
        if self.cf_mode == "user":
            nb = self.sim_ids[uids]
            terms = np.where(nb >= 0, lengths[np.maximum(nb, 0)], 0).sum(axis=1)
        else:
            terms = lengths[uids] * self.sim_ids.shape[1]
        cost = 32 * self.n_items + 48 * terms
        blocks, start, used = [], 0, 0
        for i, c in enumerate(cost):
            if i > start and used + c > SCRATCH_BYTES:
                blocks.append(uids[start:i])
                start, used = i, 0
            used += c
        blocks.append(uids[start:])
        return blocks

    def _recommend_block(self, uids, n_rec, filter_consumed):
        st = self._state()
        dev = self.device
        u = torch.as_tensor(uids, device=dev)
        B = len(uids)
        indptr, indices, data = st["indptr"], st["indices"], st["data"]
        ids, vals = st["ids"], st["vals"]
        # every term of every user's sum, in the C++'s order: UserCF
        # neighbour by neighbour, each neighbour's row; ItemCF and Swing
        # consumed item by consumed item (row order), its neighbour list
        if self.cf_mode == "user":
            nb, s = ids[u].reshape(-1), vals[u].reshape(-1)        # (B * k,)
            e, p = _ragged(indptr, nb)
            b = torch.div(e, ids.shape[1], rounding_mode="floor")
            target = indices[p]
            term = s[e].double() * data[p].double()
        else:
            b, p = _ragged(indptr, u)
            c = indices[p]
            w = (data[p].double() if self.task == "rating"
                 else torch.ones_like(p, dtype=torch.float64))
            nb, s = ids[c], vals[c]                                  # (E, k)
            hit = nb >= 0
            b = b[:, None].expand_as(nb)[hit]
            target = nb[hit]
            term = (s.double() * w[:, None])[hit]
        acc = torch.zeros(B * self.n_items, dtype=torch.float64, device=dev)
        _ordered_sums(acc, b * self.n_items + target, term)
        acc = acc.view(B, self.n_items)
        cand = acc != 0
        if filter_consumed:
            b, p = _ragged(indptr, u)
            cand[b, indices[p]] = False
        score = acc.to(torch.float32)
        key = torch.where(cand, score + 0.0, -torch.inf)
        take = min(n_rec, self.n_items)
        order = torch.argsort(key, dim=1, descending=True, stable=True)[:, :take]
        n_valid = (torch.gather(key, 1, order) > -torch.inf).sum(dim=1)
        return order.cpu().numpy(), n_valid.cpu().numpy()

    # ------------------------------------------------------------- retrain
    def rebuild_model(self, path, model_name=None):
        """Load a saved model's neighbour lists and interactions, so that the
        next ``fit`` (on ``merge_trainset``'s data) merges its rows into them
        and updates only the lists they touch."""
        if model_name is not None:
            self.model_name = model_name
        arrays = np.load(Path(path) / f"{self.model_name}_cf.npz")
        if "inter_shape" in arrays:
            shape = tuple(arrays["inter_shape"])
        else:  # a save without the shape
            shape = (
                arrays["inter_indptr"].shape[0] - 1,
                int(arrays["inter_indices"].max(initial=-1)) + 1,
            )
        old_inter = csr_matrix(
            (arrays["inter_data"], arrays["inter_indices"], arrays["inter_indptr"]),
            shape=shape,
        )
        self._old_cf_state = (arrays["sim_ids"], arrays["sim_vals"], old_inter)
        return self

    # --------------------------------------------------------- persistence
    def save(self, path, model_name=None, **kwargs):
        if model_name is not None:
            self.model_name = model_name
        Path(path).mkdir(parents=True, exist_ok=True)
        save_hyper_params(path, self)
        save_default_recs(path, self)
        np.savez_compressed(
            Path(path) / f"{self.model_name}_cf",
            sim_ids=self.sim_ids,
            sim_vals=self.sim_vals,
            inter_data=self.interaction.data,
            inter_indices=self.interaction.indices,
            inter_indptr=self.interaction.indptr,
            inter_shape=np.asarray(self.interaction.shape, np.int64),
        )
        self.data_info.save(path, self.model_name)

    @classmethod
    def load(cls, path, model_name, data_info=None, device=None, **kwargs):
        from ..data.data_info import DataInfo

        if data_info is None:
            data_info = DataInfo.load(path, model_name)
        hparams = load_hyper_params(path, model_name)
        hparams.pop("model_class", None)
        model = cls(data_info=data_info, device=device, **hparams)
        model.model_name = model_name
        arrays = np.load(Path(path) / f"{model_name}_cf.npz")
        model.sim_ids = arrays["sim_ids"]
        model.sim_vals = arrays["sim_vals"]
        model.interaction = csr_matrix(
            (arrays["inter_data"], arrays["inter_indices"], arrays["inter_indptr"]),
            shape=(model.n_users, model.n_items),
        )
        model.default_recs = load_default_recs(path, model_name)
        model.loaded = True
        return model


def _ordered_sums(acc, keys, terms):
    """``acc[keys] += terms`` where each key's terms add in their order in
    ``keys``, one after another (the C++'s sums, bit for bit): the terms go
    in rounds, the r-th term of every key in round r, each round an add
    without repeated keys."""
    if keys.numel() == 0:
        return
    order = torch.argsort(keys, stable=True)
    keys, terms = keys[order], terms[order]
    pos = torch.arange(len(keys), device=keys.device)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = torch.argsort(rank, stable=True)
    start = 0
    for n in torch.bincount(rank).tolist():
        sel = by_rank[start:start + n]
        acc[keys[sel]] += terms[sel]
        start += n


def _ragged(indptr, rows):
    """(position in ``rows``, CSR entry) of every stored entry of the rows
    ``rows`` (negative rows have none)."""
    r = rows.clamp(min=0)
    length = torch.where(rows >= 0, indptr[r + 1] - indptr[r], 0)
    b = torch.repeat_interleave(torch.arange(len(rows), device=rows.device), length)
    first = torch.cumsum(length, 0) - length
    p = torch.arange(len(b), device=rows.device) - first[b] + indptr[r][b]
    return b, p
