"""Word2vec-style base: skip-gram with negative sampling (SGNS).

Counterpart of ``librecommender_tpu/bases/w2v_base.py`` (Item2Vec,
DeepWalk): (center, context) pairs are drawn on the host from the model's
corpus once a fit (``sampling/skipgram.py``, the same numpy generator and so
the same pairs as the JAX package's), each step's negatives on the device by
inverse CDF over a float32 frequency^0.75 table (``searchsorted``, left
side; a uniform above the table's last entry gives id ``n_items``, the
context table's padding row, as in the JAX package). The three lookups
(centers, contexts, negatives) go through ``table_lookup``: on the GPU the
gather kernel, their gradient the segment-sum kernel, so same-seed fits
repeat bit for bit. Dense Adam (eps 1e-8) over both tables. A user's
embedding is the mean of their consumed items' vectors.
"""
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from .embed_base import EmbedBase
from ..ops.initializers import truncated_normal
from ..ops.table_gather import table_lookup
from ..utils.misc import aligned_rows, time_block
from ..utils.validate import check_fitting


class W2VBase(EmbedBase):
    def __init__(
        self,
        task,
        data_info,
        embed_size=16,
        norm_embed=False,
        window_size=5,
        n_epochs=5,
        learning_rate=0.005,
        batch_size=10000,
        num_neg=5,
        seed=42,
        device=None,
    ):
        if task != "ranking":
            raise ValueError(f"{self.__class__.__name__} is only suitable for ranking")
        super().__init__(task, data_info, embed_size, None, seed, device)
        self.norm_embed = norm_embed
        self.window_size = window_size
        self.n_epochs = n_epochs
        self.lr = learning_rate
        self.batch_size = batch_size
        self.num_neg = num_neg
        self._neg_cdf = None
        self._neg_gen = None
        # None: the gather kernels exactly where the model is on the GPU
        self._mxu_lookup_force = None
        self.trainer = None

    # ------------------------------------------------------------- corpus
    def _corpus(self):
        """List of item-id sequences (consumption lists or walks)."""
        raise NotImplementedError

    def _skipgram_pairs(self, corpus, rng, max_pairs=20_000_000):
        from ..sampling.skipgram import skipgram_pairs

        return skipgram_pairs(corpus, self.window_size, rng, max_pairs)

    # ------------------------------------------------------------ building
    def build_model_shell(self):
        """The negative-sampling table (frequency^0.75 inverse CDF, float32)
        and the generator of the negatives' uniforms."""
        counts = np.ones(self.n_items, np.float64)
        for i, users in self.data_info.item_consumed.items():
            counts[int(i)] += len(users)
        probs = counts ** 0.75
        self._neg_cdf = torch.from_numpy(
            np.cumsum(probs / probs.sum()).astype(np.float32)).to(self.device)
        self._neg_gen = torch.Generator(device=self.device).manual_seed(self.seed)

    def _init_params(self, generator):
        rows = aligned_rows(self.n_items)
        return {
            "item_embed": truncated_normal(generator, (rows, self.embed_size)),
            "context_embed": truncated_normal(generator, (rows, self.embed_size)),
        }

    # ------------------------------------------------------------- training
    def _uniforms(self, shape):
        """The negatives' uniforms in [0, 1), from the model's generator."""
        return torch.rand(shape, generator=self._neg_gen, device=self.device)

    def _use_kernel(self):
        force = self._mxu_lookup_force
        return force if force is not None else self.device.type == "cuda"

    def loss_fn(self, params, batch):
        centers, contexts = batch["center"], batch["context"]
        neg = torch.searchsorted(self._neg_cdf,
                                 self._uniforms((centers.shape[0], self.num_neg)))
        use = self._use_kernel()
        c_emb = table_lookup(params["item_embed"], centers, use)      # (B, D)
        pos_emb = table_lookup(params["context_embed"], contexts, use)
        neg_emb = table_lookup(params["context_embed"], neg, use)     # (B, S, D)
        pos_logit = torch.sum(c_emb * pos_emb, dim=1)
        neg_logit = torch.einsum("bd,bsd->bs", c_emb, neg_emb)
        return -torch.mean(F.logsigmoid(pos_logit)
                           + torch.sum(F.logsigmoid(-neg_logit), dim=1))

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
        """SGNS over the model's corpus, the JAX package's loop: the pairs,
        then one permutation an epoch from ``np.random.default_rng(seed)``
        (``shuffle`` is ignored, as there), batches of ``batch_size`` pairs,
        the last wrap-padded; each epoch's batches are uploaded at once and
        its losses read back once."""
        check_fitting(self, train_data, eval_data, neg_sampling, k)
        if self.net is None:
            self.build_model()
        np_rng = np.random.default_rng(self.seed)
        centers, contexts = self._skipgram_pairs(self._corpus(), np_rng)
        centers_t = torch.from_numpy(centers.astype(np.int64)).to(self.device)
        contexts_t = torch.from_numpy(contexts.astype(np.int64)).to(self.device)
        params = self.net
        keys = list(params.keys())
        optimizer = torch.optim.Adam([params[key] for key in keys], lr=self.lr,
                                     eps=1e-8)
        bs = self.batch_size
        self.trainer = SimpleNamespace(epoch_times=[], epoch_losses=[],
                                       batch_size=bs)
        for epoch in range(1, self.n_epochs + 1):
            epoch_start = time.perf_counter()
            perm = np_rng.permutation(len(centers))
            takes = []
            for start in range(0, len(perm), bs):
                take = perm[start: start + bs]
                if len(take) < bs:  # keep static shapes
                    take = np.pad(take, (0, bs - len(take)), mode="wrap")
                takes.append(take)
            with time_block(f"Epoch {epoch}", verbose):
                if takes:
                    order = torch.from_numpy(np.concatenate(takes)).to(self.device)
                losses = torch.empty(len(takes), device=self.device)
                for i in range(len(takes)):
                    rows = order[i * bs:(i + 1) * bs]
                    batch = {"center": centers_t[rows], "context": contexts_t[rows]}
                    loss = self.loss_fn(params, batch)
                    grads = torch.autograd.grad(loss, [params[key] for key in keys])
                    for key, g in zip(keys, grads):
                        params[key].grad = g
                    optimizer.step()
                    losses[i] = loss.detach()
                # the epoch's one read-back
                losses = losses.cpu()
            self.trainer.epoch_times.append(time.perf_counter() - epoch_start)
            self.trainer.epoch_losses.append(float(losses.mean()) if len(losses)
                                             else float("nan"))
            if verbose > 0 and len(losses):
                print(f"\t train_loss: {self.trainer.epoch_losses[-1]:.4f}")
        self.post_fit()

    # ----------------------------------------------------------- embeddings
    @torch.no_grad()
    def set_embeddings(self):
        item = self.net["item_embed"].detach().cpu().numpy()[: self.n_items]
        if self.norm_embed:
            item = item / np.maximum(np.linalg.norm(item, axis=1, keepdims=True), 1e-8)
        # a user is the mean of their consumed items' vectors
        user = np.zeros((self.n_users, item.shape[1]), np.float32)
        for u in range(self.n_users):
            consumed = self.data_info.user_consumed.get(u, [])
            if consumed:
                user[u] = item[np.asarray(consumed, np.int64)].mean(axis=0)
        self._set_exported(self._append_oov(user), self._append_oov(item))
