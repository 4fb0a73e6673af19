"""GraphSage: neighbour-mean aggregation over fixed-size neighbourhoods.

Counterpart of ``librecommender_tpu/models/graphsage.py``, with the same
constructor kwargs and parameter tree: ``item_w`` (and in i2i ``user_w``) a
list of ``num_layers`` dense layers, each ``h_v = act(W [h_v ; mean(h_N(v))])``
with the last layer linear; the neighbour tables are padded once on the host
(``graph/adjacency.build_neighbor_table``) and a training step draws K slots
a node on the device, where eval takes the first K. In u2i only the items run
the layers (the user side is the raw, or projected, id embedding); in i2i
both do, and training draws walk pairs (``bases/graph_base.py``). The K
neighbours' rows are gathered through ``_lookup``, so on the GPU through the
gather kernel, their gradient through the segment-sum kernel.
"""
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..bases.graph_base import GraphEmbedBase
from ..graph.adjacency import build_neighbor_table
from ..ops.initializers import truncated_normal
from ..ops.nn import dense, init_dense
from ..sampling.negatives import neg_probs_from_frequency, pos_probs_from_frequency
from ..utils.misc import aligned_rows


class GraphSage(GraphEmbedBase):
    # set by the Trainer for a fit on the GPU: lookups through the kernels
    _mxu_lookup = False

    def __init__(
        self,
        task,
        data_info,
        loss_type="cross_entropy",
        embed_size=16,
        n_epochs=20,
        lr=0.001,
        lr_decay=False,
        epsilon=1e-8,
        reg=None,
        batch_size=256,
        sampler="random",
        num_neg=1,
        dropout_rate=None,
        margin=1.0,
        amsgrad=False,
        remove_edges=False,
        num_layers=2,
        num_neighbors=10,
        max_stored_neighbors=50,
        paradigm="u2i",
        num_walks=10,
        sample_walk_len=5,
        start_node="random",
        focus_start=False,
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
        if task != "ranking":
            raise ValueError("GraphSage is only suitable for ranking")
        if paradigm not in ("u2i", "i2i"):
            raise ValueError("`paradigm` must be one of ('u2i', 'i2i')")
        if start_node not in ("random", "unpopular"):
            raise ValueError("`start_node` must be one of ('random', 'unpopular')")
        if paradigm == "i2i" and sampler is None:
            raise ValueError("the i2i paradigm requires negative sampling")
        if paradigm == "i2i" and sampler not in ("random", "popular", "out-batch"):
            raise ValueError(
                "i2i negatives are drawn on the device; sampler must be "
                "'random', 'popular' or 'out-batch'"
            )
        super().__init__(task, data_info, loss_type, embed_size, None, seed,
                         device)
        self.graph_paradigm = paradigm
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        self.reg = reg
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_neg = num_neg
        self.dropout_rate = dropout_rate or 0.0
        self.margin = margin
        self.amsgrad = amsgrad
        if remove_edges:
            warnings.warn(
                "remove_edges has no effect under full-graph propagation; "
                "per-step neighbor re-sampling plays the same role",
                stacklevel=2,
            )
        self.remove_edges = remove_edges
        self.num_layers = num_layers
        self.num_neighbors = num_neighbors
        self.max_stored_neighbors = max_stored_neighbors
        self.num_walks = num_walks
        self.sample_walk_len = sample_walk_len
        self.start_node = start_node
        self.focus_start = focus_start
        if paradigm == "i2i":
            # batch rows only set the start nodes a step: walk pairs and
            # negatives are drawn on the device, so the generator ships
            # positives only
            self.paradigm = "listwise"
        self.user_nbr = self.user_deg = None
        self.item_nbr = self.item_deg = None
        self._walk_gen = None

    def _build_graph(self):
        """The padded neighbour tables (pad 0) and their degrees, the
        feature tables, and in i2i the proposal and start distributions."""
        for side, consumed, n_rows in (
            ("user", self.data_info.user_consumed, self.n_users),
            ("item", self.data_info.item_consumed, self.n_items),
        ):
            table, deg = build_neighbor_table(consumed, n_rows,
                                              self.max_stored_neighbors, pad=0)
            setattr(self, f"{side}_nbr", torch.from_numpy(table).long().to(self.device))
            setattr(self, f"{side}_deg", torch.from_numpy(deg).to(self.device))
        self._build_feats()
        self._walk_gen = torch.Generator(device=self.device).manual_seed(self.seed)
        if self.graph_paradigm == "i2i" and self.sampler == "popular":
            p = neg_probs_from_frequency(self.data_info.item_consumed,
                                         self.n_items, 0.75)
            self._neg_probs = torch.from_numpy(p).float().to(self.device)
        if self.graph_paradigm == "i2i" and self.start_node == "unpopular":
            probs = np.asarray(pos_probs_from_frequency(
                self.data_info.item_consumed, self.n_users, self.n_items, 1e-3),
                dtype=np.float64)
            probs = np.nan_to_num(probs, nan=0.0, posinf=0.0)
            self._start_probs = torch.from_numpy(probs).float().to(self.device)

    def _init_params(self, generator):
        D = self.embed_size
        params = {
            "user_embed": truncated_normal(generator, (aligned_rows(self.n_users), D)),
            "item_embed": truncated_normal(generator, (aligned_rows(self.n_items), D)),
            "item_w": [init_dense(generator, 2 * D, D)
                       for _ in range(self.num_layers)],
        }
        if self.graph_paradigm != "u2i":
            # u2i leaves the user side un-convolved: no user weights there
            params["user_w"] = [init_dense(generator, 2 * D, D)
                                for _ in range(self.num_layers)]
        return self._init_node_feats(generator, params)

    def _sample_neighbor_mean(self, h_other, nbr_table, deg, train):
        """Mean embedding of K neighbors a node (K slots drawn uniformly in
        training, the first K stored otherwise, each reduced mod the
        degree); nodes without neighbours get zeros."""
        n_rows, T = nbr_table.shape
        K = self.num_neighbors
        if train:
            idx = self._walk_slots((n_rows, K), T)
        else:
            idx = torch.arange(K, device=self.device).expand(n_rows, K)
        idx = idx % deg.clamp_min(1.0).long()[:, None]
        picked = nbr_table.gather(1, idx)                        # (n_rows, K)
        mean = self._lookup(h_other, picked).mean(dim=1)         # (n_rows, D)
        return torch.where((deg > 0.0)[:, None], mean, 0.0)

    def _layer(self, params, h, nbr_mean, n, last, train):
        """One layer for one side's first ``n`` rows, padded back to h's rows
        with zeros; dropout in training."""
        out = dense(params, torch.cat([h[:n], nbr_mean], dim=1))
        if not last:
            out = F.relu(out)
        if train and self.dropout_rate > 0.0:
            keep = 1.0 - self.dropout_rate
            out = torch.where(self._keep_mask(out.shape, keep), out / keep, 0.0)
        return torch.cat([out, out.new_zeros(h.shape[0] - n, out.shape[1])])

    def _propagate(self, params, train):
        user_h = self._node_base(params, "user")
        item_h = self._node_base(params, "item")
        n_u, n_i = self.n_users, self.n_items
        for layer in range(self.num_layers):
            last = layer == self.num_layers - 1
            if self.graph_paradigm == "u2i":
                # the user side stays the raw (projected) embedding
                i_mean = self._sample_neighbor_mean(user_h, self.item_nbr,
                                                    self.item_deg, train)
                item_h = self._layer(params["item_w"][layer], item_h, i_mean,
                                     n_i, last, train)
                continue
            u_mean = self._sample_neighbor_mean(item_h, self.user_nbr,
                                                self.user_deg, train)
            i_mean = self._sample_neighbor_mean(user_h, self.item_nbr,
                                                self.item_deg, train)
            user_h, item_h = (
                self._layer(params["user_w"][layer], user_h, u_mean, n_u, last, train),
                self._layer(params["item_w"][layer], item_h, i_mean, n_i, last, train),
            )
        return user_h, item_h
