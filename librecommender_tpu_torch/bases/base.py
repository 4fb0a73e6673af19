"""Model contract: predict / recommend_user / save / load.

Counterpart of the inference and persistence half of
``librecommender_tpu/bases/base.py``: task handling (rating clipping vs
ranking probabilities), id conversion, default recommendations for cold
users, and the on-disk format shared with the JAX package. Training (``fit``)
comes with the training slice of the port.
"""
import abc

import numpy as np

from ..device import resolve_device
from ..utils.save_load import (
    load_default_recs,
    load_hyper_params,
    load_params,
    save_default_recs,
    save_hyper_params,
    save_params,
)


class Base(abc.ABC):
    """Base for all models.

    Parameters
    ----------
    task : {"rating", "ranking"}
    data_info : DataInfo
    lower_upper_bound : tuple or None
        Score clipping bounds for rating task.
    device : None, str or torch.device
        Where parameters live and kernels run; None means "cuda".
    """

    def __init__(self, task, data_info, lower_upper_bound=None, seed=42,
                 device=None):
        self.device = resolve_device(device)
        self.model_name = self.__class__.__name__
        self.task = task
        self.data_info = data_info
        self.n_users = data_info.n_users
        self.n_items = data_info.n_items
        self.user_consumed = data_info.user_consumed
        self.seed = seed
        self.net = None  # nn.Module holding the parameters
        self.default_recs = None
        self.loaded = False
        if task == "rating":
            self.global_mean = float(data_info.global_mean)
            if lower_upper_bound is not None:
                if not isinstance(lower_upper_bound, (list, tuple)):
                    raise TypeError("lower_upper_bound must be a list or tuple")
                self.lower_bound, self.upper_bound = lower_upper_bound
            else:
                self.lower_bound, self.upper_bound = data_info.min_max_rating
        elif task != "ranking":
            raise ValueError("task must be 'rating' or 'ranking'")

    # ------------------------------------------------------------ parameters
    @abc.abstractmethod
    def build_model(self):
        """Initialize ``self.net`` from the seed."""

    @abc.abstractmethod
    def params_from_arrays(self, params):
        """Set ``self.net`` from the saved tree of numpy arrays."""

    @abc.abstractmethod
    def params_to_arrays(self):
        """The tree of numpy arrays to save, in the JAX package's layout."""

    def fit(self, *args, **kwargs):
        raise NotImplementedError(
            "training is not ported yet: it comes with the BPR training slice "
            "(losses, Adam and lazy Adam, the trainer and the gather kernels); "
            "train with librecommender_tpu and load the saved model here"
        )

    def post_fit(self):
        """Finalize inference state from the parameters (embeddings,
        default recs)."""

    # ----------------------------------------------------------- inference
    @abc.abstractmethod
    def predict(self, user, item, inner_id=False, cold_start="average"):
        """Predict scores (rating) or probabilities (ranking) for pairs."""

    @abc.abstractmethod
    def recommend_user(self, user, n_rec, inner_id=False, cold_start="average",
                       filter_consumed=True, random_rec=False):
        """Recommend n_rec items per user; returns {user: item array}."""

    def convert_ids(self, user, item, inner_id):
        """Map raw ids to inner ids; unknowns get the OOV index."""
        user = np.atleast_1d(np.asarray(user))
        item = np.atleast_1d(np.asarray(item))
        if not inner_id:
            user = np.array([self.data_info.user2id.get(u, self.n_users) for u in user])
            item = np.array([self.data_info.item2id.get(i, self.n_items) for i in item])
        user = np.clip(user.astype(np.int64), 0, self.n_users)
        item = np.clip(item.astype(np.int64), 0, self.n_items)
        return user, item

    def finalize_rec(self, computed, users_order, inner_id):
        """Map inner item ids back to raw ids unless inner_id requested."""
        if inner_id:
            return computed
        id2item = self.data_info.id2item
        return {
            u: np.asarray([id2item.get(int(i), i) for i in recs])
            for u, recs in computed.items()
        }

    def build_default_recs(self, num=100):
        """Average-user recommendations used for cold-start 'average'."""
        try:
            recs = self._default_rec_source(num)
        except NotImplementedError:
            recs = None
        self.default_recs = recs

    def _default_rec_source(self, num):
        raise NotImplementedError

    # --------------------------------------------------------- persistence
    def save(self, path, model_name=None, **kwargs):
        if model_name is not None and model_name != self.model_name:
            self.model_name = model_name
        save_hyper_params(path, self)
        save_params(path, self.model_name, self.params_to_arrays())
        save_default_recs(path, self)
        self.data_info.save(path, self.model_name)

    @classmethod
    def load(cls, path, model_name, data_info=None, device=None, **kwargs):
        """Load a model saved by either package onto ``device``."""
        from ..data.data_info import DataInfo

        if data_info is None:
            data_info = DataInfo.load(path, model_name)
        hparams = load_hyper_params(path, model_name)
        hparams.pop("model_class", None)
        model = cls(data_info=data_info, device=device, **hparams)
        model.model_name = model_name
        model.params_from_arrays(load_params(path, model_name))
        model.default_recs = load_default_recs(path, model_name)
        model.loaded = True
        model.post_load()
        return model

    def post_load(self):
        """Rebuild cached inference state after load."""
