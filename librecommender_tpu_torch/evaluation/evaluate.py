"""Model evaluation: rating, pointwise-ranking and listwise-ranking paths.

Counterpart of ``librecommender_tpu/evaluation/evaluate.py``. Listwise
metrics go through ``model.recommend_user``, so on the GPU through the
streaming top-k kernel.
"""
import numbers

import numpy as np

from . import metrics as m
from ..data.transformed import TransformedEvalSet, TransformedSet


def _check_metrics(task, metric_names, k):
    if not isinstance(metric_names, (list, tuple)):
        metric_names = [metric_names]
    metric_names = [x.lower() for x in metric_names]
    if task == "rating":
        allowed = m.RATING_METRICS
    else:
        allowed = m.RANKING_METRICS
    for name in metric_names:
        if name not in allowed:
            raise ValueError(f"metric `{name}` is not suitable for task `{task}`")
    if not isinstance(k, numbers.Integral):
        raise TypeError("`k` must be integer")
    return metric_names


def build_eval_data(data, model=None, neg_sampling=False, seed=42, num_neg=1):
    """Normalize input into a TransformedEvalSet, sampling `num_neg` eval
    negatives per positive for ranking data that only carries positives."""
    if isinstance(data, TransformedSet):
        data = TransformedEvalSet(data.user_indices, data.item_indices, data.labels)
    if not isinstance(data, TransformedEvalSet):
        raise TypeError(
            "data must be `TransformedSet` or `TransformedEvalSet`, build it via "
            "`Dataset.build_evalset/build_testset`"
        )
    if neg_sampling and not data.has_sampled:
        data.build_negatives(model.n_items, num_neg=num_neg, seed=seed)
    return data


def compute_preds(model, data, batch_size):
    preds = []
    for start in range(0, len(data), batch_size):
        users = data.user_indices[start : start + batch_size]
        items = data.item_indices[start : start + batch_size]
        preds.append(np.asarray(model.predict(users, items, inner_id=True)))
    return np.concatenate(preds) if preds else np.array([])


def compute_probs(model, data, batch_size):
    return compute_preds(model, data, batch_size)


def sample_users(data, seed, num):
    unique_users = list(data.positive_consumed)
    if isinstance(num, numbers.Integral) and 0 < num < len(unique_users):
        rng = np.random.default_rng(seed)
        return rng.choice(unique_users, num, replace=False)
    return np.asarray(unique_users)


def compute_recommends(model, users, k, num_batch_users):
    reco_lists = {}
    for start in range(0, len(users), num_batch_users):
        batch_users = [int(u) for u in users[start : start + num_batch_users]]
        recos = model.recommend_user(
            user=batch_users, n_rec=k, inner_id=True, filter_consumed=True
        )
        for u in batch_users:
            reco_lists[u] = np.asarray(recos[u])
    return reco_lists


def evaluate(
    model,
    data,
    neg_sampling,
    eval_batch_size=8192,
    metrics=None,
    k=10,
    sample_user_num=None,
    seed=42,
    num_neg=1,
    **kwargs,
):
    """Evaluate a fitted model; returns {metric_name: value}.

    ``num_neg``: eval negatives sampled per positive when ``neg_sampling``
    (reference hardcodes 1; surfaced as a knob here)."""
    if metrics is None:
        metrics = ["loss"]
    metrics = _check_metrics(model.task, metrics, k)
    data = build_eval_data(data, model, neg_sampling, seed, num_neg=num_neg)
    result = {}

    if model.task == "rating":
        preds = compute_preds(model, data, eval_batch_size)
        labels = data.labels
        for name in metrics:
            if name == "loss":
                result[name] = float(np.mean((labels - preds) ** 2))
            elif name == "rmse":
                result[name] = m.rmse(labels, preds)
            elif name == "mae":
                result[name] = m.mae(labels, preds)
            elif name == "r2":
                result[name] = m.r2(labels, preds)
        return result

    pointwise_requested = [x for x in metrics if x in m.POINTWISE_METRICS]
    listwise_requested = [x for x in metrics if x in m.LISTWISE_METRICS]

    if pointwise_requested:
        probs = compute_probs(model, data, eval_batch_size)
        labels = data.labels
        for name in pointwise_requested:
            if name in ("loss", "log_loss"):
                result[name] = m.binary_log_loss(labels, np.clip(probs, 1e-7, 1 - 1e-7))
            elif name == "balanced_accuracy":
                result[name] = m.balanced_accuracy(labels, probs)
            elif name == "roc_auc":
                result[name] = m.roc_auc(labels, probs)
            elif name == "pr_auc":
                result[name] = m.pr_auc(labels, probs)
            elif name == "roc_gauc":
                result[name] = m.roc_gauc(labels, probs, data.user_indices)

    if listwise_requested:
        users = sample_users(data, seed, sample_user_num)
        # full-catalog scoring cost model (reference evaluate.py:135)
        num_batch_users = max(1, eval_batch_size // model.n_items)
        reco_lists = compute_recommends(model, users, k, num_batch_users)
        true_lists = data.positive_consumed
        for name in listwise_requested:
            if name == "precision":
                result[name] = m.listwise_scores(m.precision_at_k, true_lists, reco_lists, users, k)
            elif name == "recall":
                result[name] = m.listwise_scores(m.recall_at_k, true_lists, reco_lists, users, k)
            elif name == "map":
                result[name] = m.listwise_scores(m.average_precision_at_k, true_lists, reco_lists, users, k)
            elif name == "ndcg":
                result[name] = m.listwise_scores(m.ndcg_at_k, true_lists, reco_lists, users, k)
            elif name == "coverage":
                result[name] = m.coverage(np.arange(model.n_items), reco_lists, users)
    return result


def print_metrics(
    model,
    train_data=None,
    eval_data=None,
    metrics=None,
    eval_batch_size=8192,
    k=10,
    sample_user_num=2048,
    seed=42,
    neg_sampling=False,
):
    """Per-epoch metric printing (reference evaluation/evaluate.py:158)."""
    if train_data is not None:
        train_metrics = evaluate(
            model,
            train_data,
            neg_sampling,
            eval_batch_size,
            metrics=["loss"],
            seed=seed,
        )
        for name, value in train_metrics.items():
            print(f"\t train {name}: {value:.4f}")
    if eval_data is not None:
        eval_metrics = evaluate(
            model,
            eval_data,
            neg_sampling,
            eval_batch_size,
            metrics=metrics,
            k=k,
            sample_user_num=sample_user_num,
            seed=seed,
        )
        for name, value in eval_metrics.items():
            suffix = f"@{k}" if name in m.LISTWISE_METRICS else ""
            print(f"\t eval {name}{suffix}: {value:.4f}")
