"""YouTubeRetrieval: a candidate-generation tower trained with a sampled
softmax or NCE.

Counterpart of ``librecommender_tpu/models/youtube_retrieval.py``, with the
same constructor kwargs and parameter tree: the user vector is an MLP (layer
norm where ``use_bn``) over the mean-pooled input embeddings of the history
and the user's sparse and dense feature embeddings, optionally L2-normalised.
Training scores it against the output matrix ``item_embed`` plus
``item_bias`` over ``num_sampled_per_batch`` (default: the batch size)
uniform negatives shared by the batch, drawn from the model's generator
(``_shared_negatives``). The exported item table folds the bias into a last
column, as ``DynEmbedBase`` does.
"""
import torch

from ..bases.dyn_embed_base import DynEmbedBase
from ..ops.features import FeatureTables
from ..ops.initializers import truncated_normal
from ..ops.losses import nce_loss, sampled_softmax_loss
from ..ops.nn import init_mlp, mlp
from ..utils.misc import aligned_rows


class YouTubeRetrieval(DynEmbedBase):
    paradigm = "listwise"

    def __init__(
        self,
        task,
        data_info,
        loss_type="sampled_softmax",
        embed_size=16,
        norm_embed=False,
        n_epochs=20,
        lr=0.001,
        lr_decay=False,
        epsilon=1e-5,
        reg=None,
        batch_size=256,
        num_sampled_per_batch=None,
        use_bn=True,
        dropout_rate=None,
        hidden_units=(128, 64, 32),
        recent_num=10,
        random_num=None,
        multi_sparse_combiner="sqrtn",
        sampler="uniform",
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
        if task != "ranking":
            raise ValueError("YouTubeRetrieval is only suitable for ranking")
        if loss_type not in ("nce", "sampled_softmax"):
            raise ValueError(f"YouTubeRetrieval takes nce or sampled_softmax, "
                             f"got {loss_type!r}")
        super().__init__(
            task, data_info, loss_type, embed_size, norm_embed,
            recent_num, random_num, None, seed, device,
        )
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        self.reg = reg
        self.batch_size = batch_size
        self.num_sampled_per_batch = num_sampled_per_batch
        self.use_bn = use_bn
        self.dropout_rate = dropout_rate or 0.0
        self.hidden_units = tuple(hidden_units)
        self.multi_sparse_combiner = multi_sparse_combiner
        self.sampler = "random"  # the loss draws its negatives; no sampler runs
        self.num_neg = 1
        self.feats = None
        self._neg_gen = None

    def build_model_shell(self):
        super().build_model_shell()
        self.feats = FeatureTables(self.data_info, self.device)
        self._neg_gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)

    def _init_params(self, generator):
        D = self.embed_size
        i_rows = aligned_rows(self.n_items)
        params = {
            "item_embed_in": truncated_normal(generator, (i_rows, D)),
            "item_embed": truncated_normal(generator, (i_rows, D)),  # output
            "item_bias": torch.zeros((i_rows,), device=self.device),
        }
        in_dim = D
        if self.feats.user_sparse is not None:
            params["sparse_embed"] = truncated_normal(
                generator, (aligned_rows(self.feats.sparse_vocab - 1), D))
            in_dim += len(self.feats.user_sparse_pos) * D
        if self.feats.user_dense is not None:
            params["dense_embed"] = truncated_normal(
                generator, (self.feats.n_dense_fields, D))
            in_dim += len(self.feats.user_dense_pos) * D
        params["mlp"] = init_mlp(generator, in_dim, list(self.hidden_units) + [D],
                                 use_ln=self.use_bn)
        return params

    def _user_repr(self, params, users, seq, train):
        embeds = params["item_embed_in"][seq]                    # (B, L, D)
        maskf = (seq != self.pad_id).to(embeds.dtype)[:, :, None]
        pooled = (torch.sum(embeds * maskf, dim=1)
                  / torch.clamp(torch.sum(maskf, dim=1), min=1.0))
        pieces = [pooled]
        feats = self.feats
        if feats.user_sparse is not None:
            idx = feats.user_sparse[users]
            pieces.append(params["sparse_embed"][idx].reshape(idx.shape[0], -1))
        if feats.user_dense is not None:
            vals = feats.user_dense[users]
            emb = params["dense_embed"][feats.user_dense_pos]
            pieces.append((vals[:, :, None] * emb[None]).reshape(vals.shape[0], -1))
        out = mlp(params["mlp"], torch.cat(pieces, dim=1),
                  dropout_rate=self.dropout_rate, train=train,
                  generator=self._dropout_gen, final_activation=False)
        return self._normed(out)

    def _shared_negatives(self, num_sampled):
        """(num_sampled,) uniform item ids shared by the batch's rows."""
        return torch.randint(0, self.n_items, (num_sampled,), generator=self._neg_gen,
                             device=self.device)

    def loss_fn(self, params, batch):
        users, items, weight = batch["user"], batch["item"], batch["weight"]
        tree = self._tree(params)
        user_repr = self._user_repr(tree, users, batch["seq"], True)
        neg = self._shared_negatives(self.num_sampled_per_batch or users.shape[0])
        loss_impl = (sampled_softmax_loss if self.loss_type == "sampled_softmax"
                     else nce_loss)
        return loss_impl(user_repr, tree["item_embed"], tree["item_bias"], items,
                         neg, weight=weight)
