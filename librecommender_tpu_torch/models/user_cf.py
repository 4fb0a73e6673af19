"""UserCF: user-based neighbourhood collaborative filtering.

Counterpart of ``librecommender_tpu/models/user_cf.py``, with the same
constructor kwargs: the top-k similar users come from the search on the
device (``utils/similarities.py``); ``predict`` averages the neighbours'
labels of the item weighted by similarity, and ``recommend_user`` adds each
neighbour's row of labels weighted by its similarity (``bases/cf_base.py``).
"""
from ..bases.cf_base import CfBase


class UserCF(CfBase):
    cf_mode = "user"

    def __init__(
        self,
        task,
        data_info,
        sim_type="cosine",
        k_sim=20,
        store_top_k=True,
        num_threads=0,
        min_common=1,
        mode=None,
        block_size=None,  # accepted for API familiarity; ignored
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
        super().__init__(
            task, data_info, sim_type, k_sim, store_top_k, num_threads,
            min_common, mode, seed, lower_upper_bound, device,
        )
