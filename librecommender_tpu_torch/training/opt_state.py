"""The trainer's optimizer state as the JAX package's list of optax leaves.

``{name}_opt_state.npz`` and a checkpoint's ``o:leaf_*`` entries hold the
leaves of an optax state in ``jax.tree_util`` flatten order (dict keys
sorted, tuples and named tuples in field order). This module maps each
optimizer the port's trainer builds onto exactly that list, and back:

- Adam (``optax.adam``): ``(ScaleByAdamState(count, mu, nu), lr)``, where
  ``lr`` adds a ``ScaleByScheduleState(count)`` leaf with ``lr_decay`` and
  nothing for a constant rate; ``mu`` and ``nu`` over the parameters in the
  tree's order. torch's ``step`` is the count, ``exp_avg`` and
  ``exp_avg_sq`` the moments; a scheduler's ``last_epoch`` the schedule's
  count.
- AMSGrad (``optax.amsgrad``, ``training/optimizers.AMSGrad``):
  ``(ScaleByAmsgradState(count, mu, nu, nu_max), lr)``.
- lazy Adam on tables: ``(adam over the other parameters,
  {"count", "mu": {table: ...}, "nu": {table: ...}})``; with no other
  parameters the first part is Adam over an empty tree, whose count steps
  with the tables'.
- SGD (``optax.sgd``): no leaves; with momentum a ``TraceState(trace)``
  (torch's ``momentum_buffer``).
- WideDeep's ``optax.multi_transform``: ``{"deep": adam, "wide": ftrl}``,
  the FTRL state ``{"n", "z"}``, each over its own parameters.

Each leaf also carries the parameter it belongs to and whether it sits in a
subtree shaped as the whole parameter tree, which is what grafting on an
enlarged vocabulary needs (``rebuild.graft_opt_leaves``).
"""
import numpy as np
import torch

from .optimizers import AMSGrad, Ftrl, OptimizerChain
from ..utils.save_load import restore_opt_leaves, unflatten_tree


def jax_order(keys):
    """Flat parameter keys in the JAX package's tree-flatten order."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            out.append(node)

    walk(unflatten_tree({k: k for k in keys}))
    return out


class OptState:
    """The leaves of one trainer's optimizer state: ``leaves()`` reads them
    (numpy, in flatten order), ``load(leaves)`` writes them, ``layout`` says
    which parameter each belongs to."""

    def __init__(self, params, optimizer, scheduler, table_state, tables,
                 lr_decay):
        self.params = params
        self.scheduler = scheduler
        self.table_state = table_state
        key_of = {id(p): k for k, p in params.items()}
        whole = not tables
        entries = []   # (getter, setter, key, params_like)

        def moments(opt, names, like):
            keys = jax_order([key_of[id(p)] for g in opt.param_groups
                              for p in g["params"]])
            for name in names:
                for key in keys:
                    entries.append(self._slot(opt, key, name, like))

        def adam(opt, names, like):
            count_name = "count" if isinstance(opt, AMSGrad) else "step"
            entries.append(self._count(opt, count_name))
            moments(opt, names, like)

        opts = (optimizer.optimizers if isinstance(optimizer, OptimizerChain)
                else [] if optimizer is None else [optimizer])
        if isinstance(optimizer, OptimizerChain):
            # multi_transform's labels in sorted order: "deep", then "wide"
            for opt in opts:
                if isinstance(opt, torch.optim.Adam):
                    adam(opt, ("exp_avg", "exp_avg_sq"), False)
            for opt in opts:
                if isinstance(opt, Ftrl):
                    moments(opt, ("n", "z"), False)
        elif optimizer is None:
            # Adam over no parameters: its count is the tables'
            entries.append((lambda: np.asarray(table_state["count"], np.int32),
                            lambda v: None, None, False))
        elif isinstance(optimizer, AMSGrad):
            adam(optimizer, ("mu", "nu", "nu_max"), whole)
        elif isinstance(optimizer, torch.optim.Adam):
            adam(optimizer, ("exp_avg", "exp_avg_sq"), whole)
        elif isinstance(optimizer, torch.optim.SGD):
            if optimizer.defaults["momentum"]:
                moments(optimizer, ("momentum_buffer",), whole)
        else:
            raise TypeError(f"no optax layout for {type(optimizer).__name__}")
        if lr_decay and not isinstance(optimizer, (OptimizerChain, torch.optim.SGD)):
            entries.append(self._schedule(table_state))
        if tables:
            entries.append((lambda: np.asarray(table_state["count"], np.int32),
                            lambda v: table_state.__setitem__("count", int(v)),
                            None, False))
            for name in ("mu", "nu"):
                for key in sorted(tables):
                    entries.append(self._table(name, key))
        self._entries = entries
        self.layout = [(key, like) for _, _, key, like in entries]

    # each entry: (read -> numpy, write(numpy), parameter key, params_like)
    def _slot(self, opt, key, name, like):
        p = self.params[key]

        def get():
            state = opt.state.get(p, {})
            v = state.get(name)
            return (np.zeros(tuple(p.shape), np.float32) if v is None
                    else v.detach().cpu().numpy())

        def put(v):
            opt.state[p][name] = torch.as_tensor(v, dtype=p.dtype).to(p.device).clone()

        return get, put, key, like

    def _count(self, opt, name):
        def first_state():
            return next((opt.state[p] for g in opt.param_groups
                         for p in g["params"] if p in opt.state), {})

        def get():
            return np.asarray(int(first_state().get(name, 0)), np.int32)

        def put(v):
            for g in opt.param_groups:
                for p in g["params"]:
                    state = opt.state[p]
                    state[name] = (int(v) if name == "count"
                                   else torch.tensor(float(v), dtype=torch.float32))

        return get, put, None, False

    def _schedule(self, table_state):
        sched = self.scheduler

        def get():
            if sched is None:   # no parameters outside the tables
                return np.asarray(table_state["count"], np.int32)
            return np.asarray(sched.last_epoch, np.int32)

        def put(v):
            if sched is None:
                return
            sched.last_epoch = int(v)
            lrs = []
            for g, base, f in zip(sched.optimizer.param_groups, sched.base_lrs,
                                  sched.lr_lambdas):
                g["lr"] = base * f(int(v))
                lrs.append(g["lr"])
            sched._last_lr = lrs

        return get, put, None, False

    def _table(self, name, key):
        def get():
            return self.table_state[name][key].detach().cpu().numpy()

        def put(v):
            t = self.table_state[name][key]
            t.copy_(torch.as_tensor(v, dtype=t.dtype))

        return get, put, key, False

    def leaves(self):
        return [np.asarray(get()) for get, _, _, _ in self._entries]

    def load(self, leaves):
        """Write saved leaves into the optimizers (the optimizers' states are
        created where they are not yet)."""
        fresh = self.leaves()
        leaves = restore_opt_leaves(fresh, leaves)
        for i, (v, f) in enumerate(zip(leaves, fresh)):
            if v.shape != f.shape:
                raise ValueError(f"optimizer leaf {i} has shape {v.shape}, "
                                 f"the fresh state {f.shape}")
        for (_, put, _, _), v in zip(self._entries, leaves):
            put(v)
