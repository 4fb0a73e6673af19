"""Bipartite random walks and their negatives on the device, for the
item-to-item graph paradigm (GraphSage, PinSage).

Counterpart of ``walk_pairs`` and ``i2i_negatives`` in
``librecommender_tpu/graph/walks.py``: a walk goes item -> random consumer ->
random item that user consumed, ``walk_len`` hops, over the padded neighbour
tables already on the device (``graph/adjacency.build_neighbor_table``), so
every step draws fresh pairs without host work. Pairs that walk back into
their anchor, and hops from a node without neighbours, are masked by weight
instead of dropped. The draws come from callables the caller passes (the
models' seams), so a test can feed the JAX package's.
"""
import torch


def walk_pairs(start, item_nbr, item_deg, user_nbr, user_deg, num_walks,
               walk_len, focus_start, slots):
    """(anchor, positive, valid) of shape (B * num_walks * walk_len,), a start
    node's pairs contiguous; ``valid`` float32.

    start : (B,) start item nodes.
    item_nbr/item_deg : (n_items, T) padded consumers-of-item + counts.
    user_nbr/user_deg : (n_users, T) padded items-of-user + counts.
    focus_start : anchor every pair at the walk's start node (and invalidate
        returns to it); otherwise anchor at the current node.
    slots : ``slots(shape, high)`` -> int64 draws uniform in [0, high); each
        hop asks for the consumer slots, then the item slots.
    """
    cur = start.long().repeat_interleave(num_walks)       # (B*num_walks,)
    origin = cur
    anchors, positives, valids = [], [], []
    for _ in range(walk_len):
        u_slot = slots(cur.shape, item_nbr.shape[1])
        i_deg = item_deg[cur]
        user = item_nbr[cur, u_slot % i_deg.clamp_min(1.0).long()].long()
        i_slot = slots(cur.shape, user_nbr.shape[1])
        u_deg = user_deg[user]
        nxt = user_nbr[user, i_slot % u_deg.clamp_min(1.0).long()].long()
        anchor = origin if focus_start else cur
        # a node with no recorded consumers cannot move: self-pairs and
        # dead-end hops are weight-masked
        stuck = (i_deg <= 0.0) | (u_deg <= 0.0)
        anchors.append(anchor)
        positives.append(nxt)
        valids.append((nxt != anchor) & ~stuck)
        cur = nxt
    # (walk_len, B*num_walks) -> a start node's pairs contiguous
    return (torch.stack(anchors, dim=1).reshape(-1),
            torch.stack(positives, dim=1).reshape(-1),
            torch.stack(valids, dim=1).reshape(-1).float())


def i2i_negatives(anchors, positives, num_neg, propose, rounds=3,
                  out_batch=False):
    """(P, num_neg) item negatives, proposals that hit the anchor or the
    positive redrawn for ``rounds`` rounds.

    propose : ``propose(shape)`` -> one round's proposals: item ids (uniform
        or by popularity), or under ``out_batch`` rows whose positives are
        proposed.
    """
    shape = (anchors.shape[0], num_neg)

    def draw():
        cand = propose(shape)
        return positives[cand] if out_batch else cand.long()

    cand = draw()
    for _ in range(rounds):
        bad = (cand == anchors[:, None]) | (cand == positives[:, None])
        cand = torch.where(bad, draw(), cand)
    return cand
