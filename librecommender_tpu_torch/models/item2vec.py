"""Item2Vec: SGNS over user consumption lists.

Counterpart of ``librecommender_tpu/models/item2vec.py``, with the same
constructor kwargs: a user's consumed items are one sentence, and the window
defaults to 9999 (the whole list; the pairs then grow as the square of a
list's length, so long lists want a window).
"""
from ..bases.w2v_base import W2VBase


class Item2Vec(W2VBase):
    def __init__(
        self,
        task,
        data_info,
        embed_size=16,
        norm_embed=False,
        window_size=None,
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
            task, data_info, embed_size, norm_embed,
            window_size if window_size is not None else 9999,
            n_epochs, learning_rate, batch_size, num_neg, seed, device,
        )

    def _corpus(self):
        return [
            list(items) for items in self.data_info.user_consumed.values() if items
        ]
