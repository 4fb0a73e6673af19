"""Lazy (row-sparse) Adam for embedding tables, in place.

Counterpart of ``librecommender_tpu/training/sparse_optim.py``: only the
rows a step touched move, with global-step bias correction (LazyAdam: the
momentum of an untouched row is frozen, not decayed). Two forms of one
update:

- ``lazy_adam_update``, the row path: gather the touched rows' gradient and
  moments, update, write back with ``index_put_``. Duplicate ids need no
  dedup: the dense gradient already summed them, so every duplicate computes
  the same new row and writes the same bytes.
- ``dense_masked_adam_update``: masked elementwise arithmetic over the whole
  table, a row counting as touched when its gradient is not all zero. It
  differs from the row path only for a touched row whose gradient is exactly
  zero (the row path decays its momentum, this one freezes it).

Both update the parameters and moments in place under ``torch.no_grad()``.
"""
import numpy as np
import torch

#: Tables of at most this many rows take the dense masked pass under
#: ``sparse_update_mode="auto"``; larger ones the row path. Set from one
#: update of each form timed by ``chip_smoke.py`` on an H100 (700 W, 16,384
#: touched ids, three runs, PERF.md): up to 65,536 x 64 both forms are
#: launch-bound and the dense pass is 0-24% slower (0.30 vs 0.28 ms at
#: 6048 x 64, 0.33 vs 0.28 ms at 65,536 x 64); from 131,072 rows on it loses
#: by 1.8-18x (4.5 vs 0.45 ms at 1,000,000 rows). Up to 65,536 rows the
#: dense form is kept all the same: it is the JAX package's form at those
#: sizes, and the two forms differ for a touched row whose gradient is
#: exactly zero (row 0 under a padded last batch), so keeping it keeps the
#: two packages' default fits equal, for at most 0.05 ms an update.
DENSE_UPDATE_MAX_ROWS = 65536


def init_table_state(params, table_keys):
    """Zero first and second moments for each table, and the step count."""
    return {
        "mu": {k: torch.zeros_like(params[k]) for k in table_keys},
        "nu": {k: torch.zeros_like(params[k]) for k in table_keys},
        "count": 0,
    }


def _bias_corrections(count, b1, b2):
    """1 - b ** count in float32, as the JAX package computes them (in
    float64, 1 - 0.999 differs from float32's by 1e-5 relative)."""
    one, t = np.float32(1.0), np.float32(count)
    return (float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t))


@torch.no_grad()
def lazy_adam_update(params, grads, state, touched, lr, b1=0.9, b2=0.999,
                     eps=1e-5):
    """Row-sparse Adam on ``touched`` = {table_key: (N,) row ids}; ``grads``
    are the tables' dense gradients."""
    state["count"] += 1
    bc1, bc2 = _bias_corrections(state["count"], b1, b2)
    for key, idx in touched.items():
        idx = idx.reshape(-1).long()
        p, mu, nu = params[key], state["mu"][key], state["nu"][key]
        g = grads[key][idx]
        mu_new = b1 * mu[idx] + (1.0 - b1) * g
        nu_new = b2 * nu[idx] + (1.0 - b2) * torch.square(g)
        step = lr * (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
        p.index_put_((idx,), p[idx] - step)
        mu.index_put_((idx,), mu_new)
        nu.index_put_((idx,), nu_new)


@torch.no_grad()
def dense_masked_adam_update(params, grads, state, table_keys, lr,
                             b1=0.9, b2=0.999, eps=1e-5):
    """LazyAdam over whole tables with no gathers or scatters: the touched
    set is the rows whose gradient has a non-zero entry."""
    state["count"] += 1
    bc1, bc2 = _bias_corrections(state["count"], b1, b2)
    for key in table_keys:
        p, mu, nu, g = params[key], state["mu"][key], state["nu"][key], grads[key]
        mask = (g != 0.0).any(dim=-1, keepdim=True)
        mu_new = b1 * mu + (1.0 - b1) * g
        nu_new = b2 * nu + (1.0 - b2) * torch.square(g)
        step = lr * (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
        p.copy_(torch.where(mask, p - step, p))
        mu.copy_(torch.where(mask, mu_new, mu))
        nu.copy_(torch.where(mask, nu_new, nu))
