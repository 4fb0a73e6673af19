"""Pointwise, pairwise and listwise losses.

Counterpart of ``librecommender_tpu/ops/losses.py`` (mse, bce, focal, bpr,
max_margin, the in-batch and sampled softmax, nce and the contrastive SSL
loss): pure functions of logits or embeddings with an optional per-sample
``weight`` mask, so padded batch rows contribute nothing, reduced with a
masked mean. Masked logits are set to -1e9, not -inf, as in the JAX package:
a row whose every other entry is masked still has a finite log-sum-exp and
gradient.
"""
import torch
import torch.nn.functional as F


def _masked_mean(values, weight):
    if weight is None:
        return values.mean()
    weight = weight.to(values.dtype)
    return (values * weight).sum() / weight.sum().clamp_min(1.0)


def _bce_terms(logits, labels):
    """Numerically stable sigmoid cross-entropy from logits.

    ``relu`` and not ``clamp_min``: at a logit of exactly 0 its slope is 0,
    so the gradient there is the JAX package's, -label (its ``maximum``
    splits the tie in half and its |x| has slope 1 there), where
    ``clamp_min`` would give 1 - label. Every other value and gradient is the
    same. A dynamic-embedding model meets such logits at its first step: an
    empty history's representation is the zero state through zero biases."""
    return torch.relu(logits) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def mse_loss(logits, labels, weight=None):
    return _masked_mean(torch.square(logits - labels), weight)


def bce_loss(logits, labels, weight=None):
    return _masked_mean(_bce_terms(logits, labels), weight)


def focal_loss(logits, labels, weight=None, alpha=0.25, gamma=2.0):
    """Focal loss (Lin et al. 2017): ``alpha_t * (1 - p_t)^gamma * -log(p_t)``."""
    p = torch.sigmoid(logits)
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    alpha_t = labels * alpha + (1.0 - labels) * (1.0 - alpha)
    per = alpha_t * torch.pow(1.0 - p_t, gamma) * _bce_terms(logits, labels)
    return _masked_mean(per, weight)


def bpr_loss(pos_scores, neg_scores, weight=None):
    """Bayesian Personalized Ranking: -log sigmoid(pos - neg)."""
    return _masked_mean(-F.logsigmoid(pos_scores - neg_scores), weight)


def max_margin_loss(pos_scores, neg_scores, weight=None, margin=1.0):
    return _masked_mean(torch.clamp_min(margin - pos_scores + neg_scores, 0.0), weight)


def pointwise_loss(task, loss_type):
    """The pointwise loss of a model: mse for the rating task, else bce
    (``cross_entropy``) or focal."""
    if task == "rating":
        return mse_loss
    return bce_loss if loss_type == "cross_entropy" else focal_loss


# ---------------------------------------------------------------- listwise
MASKED_LOGIT = -1e9


def softmax_cross_entropy_loss(
    user_embeds,
    item_embeds,
    weight=None,
    item_ids=None,
    correction_probs=None,
    temperature=1.0,
    remove_accidental_hits=False,
):
    """In-batch sampled softmax over the batch's items.

    logits[i, j] = <u_i, v_j> / T - log(p_j) (the log-popularity correction
    of the in-batch sampling bias); the diagonal is the positive. The
    positive logit comes from the paired vectors and joins the denominator
    through ``logaddexp``, so neither a (B, B) ``log_softmax`` nor the
    diagonal's backward is ever made. Masked out of every row's denominator:
    the diagonal (or, with hit removal, every column whose item id is the
    row's positive) and the columns of padded rows (``weight <= 0``).
    """
    logits = (user_embeds @ item_embeds.T) / temperature
    diag = torch.sum(user_embeds * item_embeds, dim=1) / temperature
    if correction_probs is not None:
        logp = torch.log(torch.clamp(correction_probs, 1e-8, 1.0))
        logits = logits - logp[None, :]
        diag = diag - logp
    if remove_accidental_hits and item_ids is not None:
        mask = item_ids[None, :] == item_ids[:, None]
    else:
        mask = torch.eye(logits.shape[0], dtype=torch.bool, device=logits.device)
    if weight is not None:
        mask = mask | (weight <= 0.0)[None, :]
    lse_rest = torch.logsumexp(logits.masked_fill(mask, MASKED_LOGIT), dim=1)
    per = torch.logaddexp(lse_rest, diag) - diag
    return _masked_mean(per, weight)


def _shared_candidate_logits(user_embeds, item_weights, item_biases, pos_items,
                             neg_items):
    """(B,) positive logits and (B, S) logits of the shared candidates."""
    pos_logit = (torch.sum(user_embeds * item_weights[pos_items], dim=1)
                 + item_biases[pos_items])
    neg_logits = user_embeds @ item_weights[neg_items].T + item_biases[neg_items][None, :]
    return pos_logit, neg_logits


def sampled_softmax_loss(
    user_embeds,
    item_weights,
    item_biases,
    pos_items,
    neg_items,
    weight=None,
    remove_accidental_hits=True,
):
    """Sampled softmax over shared negative candidates: each row's candidates
    are its positive and ``neg_items`` (S,), drawn uniformly and shared by
    the batch, so no log-uniform correction. A candidate equal to the row's
    positive is masked; the positive joins through ``logaddexp``."""
    pos_logit, neg_logits = _shared_candidate_logits(
        user_embeds, item_weights, item_biases, pos_items, neg_items)
    if remove_accidental_hits:
        hit = neg_items[None, :] == pos_items[:, None]
        neg_logits = neg_logits.masked_fill(hit, MASKED_LOGIT)
    lse_neg = torch.logsumexp(neg_logits, dim=1)
    per = torch.logaddexp(lse_neg, pos_logit) - pos_logit
    return _masked_mean(per, weight)


def nce_loss(
    user_embeds,
    item_weights,
    item_biases,
    pos_items,
    neg_items,
    weight=None,
):
    """Noise-contrastive estimation with shared uniform negatives: a binary
    logistic loss on the positive and on each shared candidate."""
    pos_logit, neg_logits = _shared_candidate_logits(
        user_embeds, item_weights, item_biases, pos_items, neg_items)
    pos_loss = -F.logsigmoid(pos_logit)
    neg_loss = -torch.sum(F.logsigmoid(-neg_logits), dim=1)
    return _masked_mean(pos_loss + neg_loss, weight)


def ssl_loss(view1_embeds, view2_embeds, temperature=1.0):
    """Contrastive self-supervised loss between two views of the same items:
    cosine logits over the batch, the matching view the positive."""
    v1 = view1_embeds / torch.clamp(
        torch.linalg.vector_norm(view1_embeds, dim=1, keepdim=True), min=1e-8)
    v2 = view2_embeds / torch.clamp(
        torch.linalg.vector_norm(view2_embeds, dim=1, keepdim=True), min=1e-8)
    log_probs = F.log_softmax((v1 @ v2.T) / temperature, dim=1)
    return -torch.mean(torch.diagonal(log_probs))


LISTWISE_LOSSES = ("softmax", "nce", "sampled_softmax")
