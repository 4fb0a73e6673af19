"""Pointwise and pairwise losses.

Counterpart of ``librecommender_tpu/ops/losses.py`` (mse, bce, focal, bpr,
max_margin): pure functions of logits with an optional per-sample ``weight``
mask, so padded batch rows contribute nothing, reduced with a masked mean.
The listwise losses come with the retrieval family.
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
