"""Epoch arrays and host-drawn negatives for the trainer.

Counterpart of ``adjust_batch_size`` and ``BatchGenerator.epoch_arrays`` /
``epoch_negatives`` in ``librecommender_tpu/batch/generator.py``: the
trainer uploads the epoch's row-aligned index arrays once per fit, padded to
whole batches (pad rows carry weight 0), and shuffles on the device. With
``sampler="popular"`` or ``"unconsumed"`` the negatives are drawn here, on
the host, once per epoch, from the same numpy generator as the JAX package's;
``sampler="random"`` leaves them to the device.
"""
import numpy as np

from ..sampling.negatives import (
    neg_probs_from_frequency,
    negatives_from_popular,
    negatives_from_random,
    negatives_from_unconsumed,
)


def adjust_batch_size(model, original_batch_size):
    """``batch_size`` counts all examples of a step, negatives included (the
    reference's semantics): pairwise models divide it by ``num_neg``,
    pointwise sampling models by ``num_neg + 1``, and item-to-item graph
    models, whose every start node expands into ``num_walks *
    sample_walk_len`` walk pairs on the device, by that and ``num_neg``."""
    if getattr(model, "graph_paradigm", None) == "i2i":
        bs = (original_batch_size / model.num_neg / model.num_walks
              / model.sample_walk_len)
        return max(1, int(bs))
    paradigm = getattr(model, "paradigm", "pointwise")
    if paradigm == "listwise":
        return original_batch_size
    if getattr(model, "sampler", None) is not None:
        if getattr(model, "loss_type", None) in ("cross_entropy", "focal"):
            return max(1, int(original_batch_size / (model.num_neg + 1)))
        return max(1, int(original_batch_size / model.num_neg))
    return original_batch_size


class BatchGenerator:
    """Fixed-shape epoch arrays and per-epoch negatives.

    Parameters
    ----------
    train_data : TransformedSet
    data_info : DataInfo
    batch_size : int
    paradigm : {"pointwise", "pairwise", "listwise"}
    neg_sampling : bool
    sampler : {"random", "popular", "unconsumed"}
    num_neg : int
    seed : int
    extras : dict of row-aligned arrays or None
    """

    def __init__(
        self,
        train_data,
        data_info,
        batch_size,
        paradigm,
        neg_sampling,
        sampler="random",
        num_neg=1,
        seed=42,
        temperature=0.75,
        extras=None,
    ):
        if paradigm not in ("pointwise", "pairwise", "listwise"):
            raise ValueError(f"unknown paradigm {paradigm!r}")
        # row-aligned extra arrays (e.g. per-row training sequences) sliced
        # into every batch under their key
        self.extras = extras or {}
        self.user_indices = np.asarray(train_data.user_indices, dtype=np.int32)
        self.item_indices = np.asarray(train_data.item_indices, dtype=np.int32)
        self.labels = np.asarray(train_data.labels, dtype=np.float32)
        self.data_info = data_info
        self.n_items = data_info.n_items
        self.batch_size = batch_size
        self.paradigm = paradigm
        self.neg_sampling = neg_sampling
        self.sampler = sampler
        self.num_neg = num_neg
        self.rng = np.random.default_rng(seed)
        self.device_side_sampling = (
            neg_sampling and sampler == "random" and paradigm in ("pointwise", "pairwise")
        )
        if neg_sampling and sampler == "popular":
            self.neg_probs = neg_probs_from_frequency(
                data_info.item_consumed, self.n_items, temperature
            )
        else:
            self.neg_probs = None
        if neg_sampling and sampler == "unconsumed":
            self.consumed_set = {
                u: set(items) for u, items in data_info.user_consumed.items()
            }

    @property
    def has_host_negatives(self):
        """True when negatives are host-sampled per epoch (popular /
        unconsumed samplers on the pointwise/pairwise paradigms)."""
        return (
            self.neg_sampling
            and not self.device_side_sampling
            and self.paradigm != "listwise"
        )

    @property
    def n_samples(self):
        return len(self.labels)

    def n_batches(self):
        return -(-self.n_samples // self.batch_size)

    def _sample_negatives(self, items_pos, users):
        if self.sampler == "popular":
            return negatives_from_popular(
                self.rng, self.n_items, items_pos, self.num_neg, probs=self.neg_probs
            )
        if self.sampler == "unconsumed":
            return negatives_from_unconsumed(
                self.consumed_set,
                users,
                items_pos,
                self.n_items,
                self.num_neg,
                seed=int(self.rng.integers(0, 2**31)),
            )
        return negatives_from_random(self.rng, self.n_items, items_pos, self.num_neg)

    def epoch_arrays(self):
        """Row-aligned arrays padded to n_batches * batch_size (pad rows
        carry weight 0): int32 user/item, float32 label/weight, and the
        extras under their keys."""
        total = self.n_batches() * self.batch_size
        out = {
            "user": _pad(self.user_indices, total),
            "item": _pad(self.item_indices, total),
            "label": _pad(self.labels, total),
            "weight": _pad(np.ones(self.n_samples, np.float32), total),
        }
        for key, arr in self.extras.items():
            out[key] = _pad(np.asarray(arr), total)
        return out

    def epoch_negatives(self):
        """Per-epoch host-sampled negatives (n_batches * batch_size, num_neg)
        int32, padded like epoch_arrays; None when sampling is on the device
        or off."""
        if not self.has_host_negatives:
            return None
        total = self.n_batches() * self.batch_size
        negs = self._sample_negatives(self.item_indices, self.user_indices)
        negs = negs.reshape(-1, self.num_neg).astype(np.int32)
        return _pad(negs, total)


def _pad(arr, size):
    """Right-pad axis 0 to `size` with zeros (mask handled by `weight`)."""
    n = arr.shape[0]
    if n == size:
        return arr
    pad_width = [(0, size - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width)
