"""Evaluation metrics: rating, pointwise ranking and listwise ranking.

Counterpart of ``librecommender_tpu/evaluation/metrics.py``. The JAX package
delegates the rating and pointwise metrics to scikit-learn; here they are
numpy and scipy, computed the way scikit-learn computes them: ROC AUC as the
Mann-Whitney statistic on average ranks, PR AUC from the precision-recall
curve at the distinct scores, and log-loss in the probabilities' own dtype.
"""
import numpy as np
from scipy.stats import rankdata

RATING_METRICS = {"loss", "rmse", "mae", "r2"}
POINTWISE_METRICS = {"loss", "log_loss", "balanced_accuracy", "roc_auc", "pr_auc", "roc_gauc"}
LISTWISE_METRICS = {"precision", "recall", "map", "ndcg", "coverage"}
RANKING_METRICS = POINTWISE_METRICS | LISTWISE_METRICS


def _float_columns(labels, preds):
    """Both arrays as (n, 1) columns in their common float dtype (float64
    unless both are float32): scikit-learn's layout and dtype for the rating
    metrics, kept so that the sums round as its do."""
    labels, preds = np.asarray(labels), np.asarray(preds)
    dtype = np.result_type(labels, preds)
    if dtype not in (np.float32, np.float64):
        dtype = np.float64
    return (labels.astype(dtype, copy=False).reshape(-1, 1),
            preds.astype(dtype, copy=False).reshape(-1, 1))


def rmse(labels, preds):
    labels, preds = _float_columns(labels, preds)
    return float(np.sqrt(float(np.mean((labels - preds) ** 2, axis=0)[0])))


def mae(labels, preds):
    labels, preds = _float_columns(labels, preds)
    return float(np.mean(np.abs(preds - labels), axis=0)[0])


def r2(labels, preds):
    """1 - residual / total sum of squares; 1.0 (perfect) or 0.0 when the
    labels are constant."""
    labels, preds = _float_columns(labels, preds)
    num = np.sum((labels - preds) ** 2, axis=0)[0]
    den = np.sum((labels - np.mean(labels, axis=0)) ** 2, axis=0)[0]
    if den == 0.0:
        return 1.0 if num == 0.0 else 0.0
    return float(1.0 - num / den)


def binary_log_loss(labels, probs):
    """Mean negative log-likelihood of 0/1 labels, in the probabilities' own
    float dtype, each probability clipped to [eps, 1 - eps] of that dtype."""
    probs = np.asarray(probs)
    if probs.dtype not in (np.float32, np.float64):
        probs = probs.astype(np.float64)
    labels = np.asarray(labels) == 1
    eps = np.finfo(probs.dtype).eps
    p_pos = np.clip(probs, eps, 1 - eps)
    p_neg = np.clip(1 - probs, eps, 1 - eps)
    loss = -np.log(np.where(labels, p_pos, p_neg))
    return float(np.mean(loss))


def balanced_accuracy(labels, probs):
    """Mean recall over the classes present in ``labels``, predictions
    rounded to 0/1."""
    labels = np.asarray(labels)
    preds = np.round(np.asarray(probs))
    recalls = [np.mean(preds[labels == c] == c) for c in np.unique(labels)]
    return float(np.mean(recalls))


def roc_auc(labels, probs):
    """Area under the ROC curve: the Mann-Whitney U of the positives' average
    ranks, which counts a tie as half a win."""
    labels = np.asarray(labels) == 1
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError(
            "Only one class present in y_true. ROC AUC score is not defined "
            "in that case."
        )
    ranks = rankdata(np.asarray(probs), method="average")
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def pr_auc(labels, probs):
    """Area under the precision-recall curve, by trapezoids: one point per
    distinct score, the curve cut where recall first reaches 1, and the
    (recall 0, precision 1) end point."""
    labels = np.asarray(labels) == 1
    probs = np.asarray(probs)
    order = np.argsort(probs, kind="mergesort")[::-1]
    scores, hits = probs[order], labels[order]
    last_of_score = np.r_[np.nonzero(np.diff(scores))[0], len(scores) - 1]
    tps = np.cumsum(hits, dtype=np.float64)[last_of_score]
    fps = 1.0 + last_of_score - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    full = np.searchsorted(tps, tps[-1])
    precision = np.r_[precision[full::-1], 1.0]
    recall = np.r_[recall[full::-1], 0.0]
    # numpy's trapezoid rule, written out (np.trapz was renamed in numpy 2)
    return float(-(np.diff(recall) * (precision[1:] + precision[:-1]) / 2.0).sum())


def roc_gauc(labels, probs, users):
    """Per-user ROC AUC averaged with per-user sample weights; users with a
    single class contribute nothing."""
    labels = np.asarray(labels)
    probs = np.asarray(probs)
    users = np.asarray(users)
    order = np.argsort(users, kind="stable")
    labels, probs, users = labels[order], probs[order], users[order]
    bounds = np.nonzero(np.diff(users))[0] + 1
    total_auc, total_weight = 0.0, 0
    for seg_l, seg_p in zip(np.split(labels, bounds), np.split(probs, bounds)):
        if seg_l.min() == seg_l.max():
            continue
        total_auc += len(seg_l) * roc_auc(seg_l, seg_p)
        total_weight += len(seg_l)
    return float(total_auc / total_weight) if total_weight else 0.0


# ----------------------------------------------------------------- listwise
def listwise_scores(fn, y_true_lists, y_reco_lists, users, k):
    scores = [
        fn(y_true_lists[u], y_reco_lists[u], k)
        for u in users
        if u in y_reco_lists and len(y_reco_lists[u]) > 0
    ]
    return float(np.mean(scores)) if scores else 0.0


def precision_at_k(y_true, y_reco, k):
    return len(set(y_true) & set(y_reco[:k])) / k


def recall_at_k(y_true, y_reco, k):
    if len(y_true) == 0:
        return 0.0
    return len(set(y_true) & set(y_reco[:k])) / len(y_true)


def average_precision_at_k(y_true, y_reco, k):
    true_set = set(y_true)
    hits, precision_sum = 0, 0.0
    for i, item in enumerate(y_reco[:k], start=1):
        if item in true_set:
            hits += 1
            precision_sum += hits / i
    denom = min(len(true_set), k)
    return precision_sum / denom if denom else 0.0


def ndcg_at_k(y_true, y_reco, k):
    """The reference's NDCG: IDCG normalizes by the number of hits in the
    recommendation list, not by min(|truth|, k)."""
    true_set = set(y_true)
    rels = np.asarray([1.0 if item in true_set else 0.0 for item in y_reco[:k]])
    if not np.any(rels):
        return 0.0
    discounts = 1.0 / np.log2(np.arange(2, len(rels) + 2))
    dcg = float(np.sum(rels * discounts))
    n_hits = int(np.sum(rels))
    idcg = float(np.sum(discounts[:n_hits]))
    return dcg / idcg if idcg else 0.0


def coverage(all_item_ids, y_reco_lists, users):
    recommended = set()
    for u in users:
        recommended.update(y_reco_lists.get(u, ()))
    return len(recommended) / len(all_item_ids)
