"""Swing: item-item substitution scores from user-pair co-consumption.

Counterpart of ``librecommender_tpu/models/swing.py``, with the same
constructor kwargs (``max_cache_num`` accepted and ignored): score(i, j) is
the sum over user pairs (u, v) sharing c >= 2 items, i and j among them, of
``1 / (alpha + c)``. The pair pass runs through ``ops/swing.py`` (the kernel
of ``csrc/swing.cu`` on the GPU), which keeps each item's top-k; inference is
ItemCF's over those lists (``bases/cf_base.py``). Ranking task only.

As in the JAX package, ``fit`` after ``rebuild_model`` does not merge the
saved state: it scores the data it is given from scratch.
"""
import numpy as np
from scipy.sparse import csr_matrix

from ..bases.cf_base import CfBase
from ..ops.swing import interaction_lists, swing_topk
from ..utils.misc import time_block
from ..utils.validate import check_fitting


class Swing(CfBase):
    cf_mode = "item"

    def __init__(
        self,
        task,
        data_info,
        top_k=20,
        alpha=1.0,
        max_cache_num=100_000_000,  # accepted for API familiarity; ignored
        num_threads=0,
        seed=42,
        device=None,
    ):
        # `device` stays out of all_args: the JAX package loads the saved
        # hyper-params as kwargs and has no such argument
        self.all_args = {
            k: v for k, v in locals().items()
            if k not in ("self", "__class__", "data_info", "device")
        }
        if task != "ranking":
            raise ValueError("Swing is only suitable for ranking")
        super().__init__(task, data_info, "cosine", top_k, True, num_threads,
                         1, None, seed, None, device)
        self.alpha = alpha
        self.top_k = top_k

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
        check_fitting(self, train_data, eval_data, neg_sampling, k)
        mat = train_data.sparse_interaction
        self.interaction = csr_matrix(
            (mat.data, mat.indices, mat.indptr),
            shape=(self.n_users, self.n_items),
        )
        lists = interaction_lists(self.interaction, self.device)
        with time_block("swing scores", verbose):
            self.sim_ids, self.sim_vals = swing_topk(
                lists, self.n_items, self.alpha, self.top_k)
        self.post_fit()
        self._print_eval(verbose, eval_data, metrics, eval_batch_size, k,
                         eval_user_num, neg_sampling)

    @property
    def default_pred(self):
        return 0.0
