"""DeepWalk: truncated random walks on the item co-occurrence graph + SGNS.

Counterpart of ``librecommender_tpu/models/deepwalk.py``, with the same
constructor kwargs: ``n_walks`` walks of up to ``walk_length`` items from
every item, each hop item -> random consumer -> random item that user
consumed, drawn on the host from ``np.random.default_rng(seed)`` (the same
walks as the JAX package's), are the sentences.
"""
import numpy as np

from ..bases.w2v_base import W2VBase


class DeepWalk(W2VBase):
    def __init__(
        self,
        task,
        data_info,
        embed_size=16,
        norm_embed=False,
        n_walks=10,
        walk_length=10,
        window_size=5,
        n_epochs=5,
        learning_rate=0.005,
        batch_size=10000,
        num_neg=5,
        n_threads=0,  # accepted for API familiarity (gensim workers); ignored
        seed=42,
        lower_upper_bound=None,  # accepted for API familiarity (ranking-only)
        device=None,
    ):
        # `device` stays out of all_args: the JAX package loads the saved
        # hyper-params as kwargs and has no such argument
        self.all_args = {
            k: v for k, v in locals().items()
            if k not in ("self", "__class__", "data_info", "device")
        }
        super().__init__(
            task, data_info, embed_size, norm_embed, window_size,
            n_epochs, learning_rate, batch_size, num_neg, seed, device,
        )
        self.n_walks = n_walks
        self.walk_length = walk_length

    def _corpus(self):
        rng = np.random.default_rng(self.seed)
        item_users = {
            int(i): np.asarray(us, np.int64)
            for i, us in self.data_info.item_consumed.items()
        }
        user_items = {
            int(u): np.asarray(its, np.int64)
            for u, its in self.data_info.user_consumed.items()
        }
        walks = []
        for start in range(self.n_items):
            for _ in range(self.n_walks):
                walk = [start]
                cur = start
                while len(walk) < self.walk_length:
                    us = item_users.get(cur)
                    if us is None or us.size == 0:
                        break
                    u = int(us[rng.integers(us.size)])
                    its = user_items.get(u)
                    if its is None or its.size == 0:
                        break
                    cur = int(its[rng.integers(its.size)])
                    walk.append(cur)
                if len(walk) > 1:
                    walks.append(walk)
        return walks
