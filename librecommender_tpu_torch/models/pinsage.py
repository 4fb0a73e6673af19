"""PinSage: importance-weighted neighbour aggregation.

Counterpart of ``librecommender_tpu/models/pinsage.py``, with the same
constructor kwargs and parameter tree as GraphSage's: an item's
neighbourhood is its top ``num_neighbors`` most-visited items on
``num_walks`` bipartite random walks from it, weighted by visit count
(``graph/adjacency.pinsage_neighbor_table``, on the host from ``seed``,
padded with ``n_items`` at weight 0), and a layer is ``act(W [h_v ;
sum_t w_t h_t])``, the last layer linear. In i2i users aggregate a uniform
draw of their consumed items, as GraphSage's; in u2i the user side is the
raw (projected) embedding. The neighbourhood rows are gathered through
``_lookup``, so on the GPU through the gather kernel; the padding id reads
a row of the item table's padding (at weight 0, so no gradient).
"""
import torch

from .graphsage import GraphSage
from ..graph.adjacency import pinsage_neighbor_table


class PinSage(GraphSage):
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
        num_walks=10,
        neighbor_walk_len=2,
        termination_prob=0.5,
        max_stored_neighbors=50,
        paradigm="u2i",
        sample_walk_len=5,
        start_node="random",
        focus_start=False,
        seed=42,
        lower_upper_bound=None,  # accepted for API familiarity (ranking-only)
        device=None,
    ):
        super().__init__(
            task, data_info, loss_type, embed_size, n_epochs, lr, lr_decay,
            epsilon, reg, batch_size, sampler, num_neg,
            dropout_rate=dropout_rate, margin=margin, amsgrad=amsgrad,
            remove_edges=remove_edges, num_layers=num_layers,
            num_neighbors=num_neighbors,
            max_stored_neighbors=max_stored_neighbors, paradigm=paradigm,
            num_walks=num_walks, sample_walk_len=sample_walk_len,
            start_node=start_node, focus_start=focus_start, seed=seed,
            device=device,
        )
        self.all_args.update(
            num_walks=num_walks, neighbor_walk_len=neighbor_walk_len,
            termination_prob=termination_prob,
        )
        self.neighbor_walk_len = neighbor_walk_len
        self.termination_prob = termination_prob
        self.item_item_nbr = None
        self.item_item_w = None

    def _build_graph(self):
        nbr, w = pinsage_neighbor_table(
            self.data_info.user_consumed,
            self.data_info.item_consumed,
            self.n_items,
            num_walks=self.num_walks,
            walk_len=self.neighbor_walk_len,
            top_t=self.num_neighbors,
            termination_prob=self.termination_prob,
            seed=self.seed,
        )
        self.item_item_nbr = torch.from_numpy(nbr).long().to(self.device)
        self.item_item_w = torch.from_numpy(w).to(self.device)
        super()._build_graph()

    def _propagate(self, params, train):
        user_h = self._node_base(params, "user")
        item_h = self._node_base(params, "item")
        n_u, n_i = self.n_users, self.n_items
        u2i = self.graph_paradigm == "u2i"
        for layer in range(self.num_layers):
            last = layer == self.num_layers - 1
            # items: importance-weighted mean over walk neighbourhoods
            nbr = self._lookup(item_h, self.item_item_nbr)       # (n_i, T, D)
            i_mean = torch.einsum("ntd,nt->nd", nbr, self.item_item_w)
            if u2i:
                item_h = self._layer(params["item_w"][layer], item_h, i_mean,
                                     n_i, last, train)
                continue
            # users: uniform mean over consumed items
            u_mean = self._sample_neighbor_mean(item_h, self.user_nbr,
                                                self.user_deg, train)
            user_h, item_h = (
                self._layer(params["user_w"][layer], user_h, u_mean, n_u, last, train),
                self._layer(params["item_w"][layer], item_h, i_mean, n_i, last, train),
            )
        return user_h, item_h
