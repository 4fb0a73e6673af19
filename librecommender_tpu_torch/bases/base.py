"""Model contract: fit / predict / recommend_user / save / load.

Counterpart of ``librecommender_tpu/bases/base.py``: task handling (rating
clipping vs ranking probabilities), id conversion, default recommendations
for cold users, the on-disk format shared with the JAX package, and the
``fit`` skeleton that runs the shared trainer. Retraining from a saved model
(``rebuild_model``, ``load_checkpoint``) comes with the retrain slice.
"""
import abc
import time

import numpy as np
import torch
from torch import nn

from ..convert import tree_params_from_jax, tree_params_to_jax
from ..device import resolve_device
from ..evaluation.evaluate import print_metrics
from ..training.trainer import Trainer
from ..utils.misc import colorize
from ..utils.save_load import (
    flatten_tree,
    load_default_recs,
    load_hyper_params,
    load_params,
    save_default_recs,
    save_hyper_params,
    save_params,
    unflatten_tree,
)
from ..utils.validate import check_fitting, check_unknown_user


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

    # training paradigm consumed by the Trainer/BatchGenerator
    paradigm = "pointwise"

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
    # ``self.net`` is one flat ``nn.ParameterDict`` of the model's nested
    # parameter tree (``_init_params``, the JAX package's layout), keyed by
    # the saved npz names (``att/mlp/layers#0/dense/w``); ``_tree`` is the
    # nested view of the same tensors. Static state beside the parameters
    # (feature and history tables, generators) is rebuilt by
    # ``build_model_shell`` before the parameters are built or loaded.
    def build_model_shell(self):
        """Rebuild the static state beside the parameters (none here)."""

    def _init_params(self, generator):
        """The nested parameter tree, in the JAX package's layout."""
        raise NotImplementedError

    def _fresh_params(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return self._init_params(gen)

    def build_model(self):
        """Random parameters from the seed."""
        self.build_model_shell()
        self.net = nn.ParameterDict({
            k: nn.Parameter(v) for k, v in flatten_tree(self._fresh_params()).items()
        })

    def params_from_arrays(self, params):
        """Set ``self.net`` from a saved tree of numpy arrays (either
        package's), refused unless its keys and shapes are the model's."""
        self.build_model_shell()
        shapes = {k: tuple(v.shape)
                  for k, v in flatten_tree(self._fresh_params()).items()}
        self.net = nn.ParameterDict({
            k: nn.Parameter(v)
            for k, v in tree_params_from_jax(params, shapes, self.device).items()
        })

    def params_to_arrays(self):
        """The tree of numpy arrays to save, in the JAX package's layout."""
        return tree_params_to_jax(self.net)

    def _tree(self, params=None):
        """The nested view of the flat parameters (the same tensors)."""
        return unflatten_tree(dict((self.net if params is None else params).items()))

    @abc.abstractmethod
    def loss_fn(self, params, batch):
        """Scalar loss of one batch (a dict of device tensors) under
        ``params`` (``self.net``), differentiable in the parameters."""

    def _custom_optimizer(self):
        """Optional optimizer factory ``params -> torch.optim.Optimizer``
        replacing the default Adam."""
        return None

    def post_epoch(self):
        """Refresh any cached inference state after an epoch."""

    def batch_extras(self, train_data):
        """Row-aligned extra arrays sliced into every batch under their key
        (e.g. per-row training sequences), or None."""
        return None

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
        num_workers=0,
        mesh=None,
        profile_dir=None,
        checkpoint_dir=None,
        checkpoint_every=1,
        early_stopping=None,
    ):
        """Train the model on transformed train data, on ``self.device``.

        ``self.net`` is built from the seed unless it already exists, so
        parameters set beforehand (``params_from_arrays``) are where training
        starts. ``profile_dir``: write a ``torch.profiler`` trace of the
        second epoch there. ``early_stopping``: patience in epochs (requires
        ``eval_data``) on the first entry of ``metrics``; the best epoch's
        parameters are kept. ``num_workers`` is accepted and ignored, as in
        the JAX package; ``mesh`` and ``checkpoint_dir`` (with
        ``checkpoint_every``) raise until the multi-device and retrain
        slices.
        """
        if verbose > 0:
            start = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
            print(f"Training start time: {colorize(start, 'magenta')}")
        check_fitting(self, train_data, eval_data, neg_sampling, k)
        if self.net is None:
            self.build_model()
        trainer = Trainer(
            self,
            n_epochs=self.n_epochs,
            lr=self.lr,
            lr_decay=self.lr_decay,
            epsilon=self.epsilon,
            batch_size=self.batch_size,
            sampler=getattr(self, "sampler", "random"),
            num_neg=getattr(self, "num_neg", 1),
            optimizer=self._custom_optimizer(),
            mesh=mesh,
        )
        trainer.run(
            train_data,
            neg_sampling,
            verbose,
            shuffle,
            eval_data,
            metrics,
            k=k,
            eval_batch_size=eval_batch_size,
            eval_user_num=eval_user_num,
            profile_dir=profile_dir,
            checkpoint_dir=checkpoint_dir,
            early_stopping=early_stopping,
        )
        self.trainer = trainer
        self.post_fit()
        if verbose > 1 and eval_data is not None:
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

    def split_cold_users(self, user, inner_id):
        """(known inner ids, unknown users) of one user or a list."""
        return check_unknown_user(self.data_info, user, inner_id)

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
