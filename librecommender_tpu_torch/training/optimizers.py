"""FTRL-Proximal and a chain of optimizers over disjoint parameter sets.

Counterpart of ``librecommender_tpu/training/optimizers.py`` (FTRL-Proximal,
McMahan et al. 2013, for WideDeep's wide part): the same z / n accumulators,
zero-initialised, and the same closed-form proximal step, which sets each
weight to its new value rather than adding a step to it.
"""
import torch


class Ftrl(torch.optim.Optimizer):
    def __init__(self, params, lr, lr_power=-0.5, l1=0.0, l2=0.0, beta=0.0):
        super().__init__(params, dict(lr=lr, lr_power=lr_power, l1=l1, l2=l2,
                                      beta=beta))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            lr, power = group["lr"], -group["lr_power"]
            l1, l2, beta = group["l1"], group["l2"], group["beta"]
            for w in group["params"]:
                if w.grad is None:
                    continue
                g = w.grad
                state = self.state[w]
                if not state:
                    state["z"] = torch.zeros_like(w)
                    state["n"] = torch.zeros_like(w)
                z, n = state["z"], state["n"]
                n_new = n + g * g
                sigma = (n_new.pow(power) - n.pow(power)) / lr
                z.add_(g - sigma * w)
                n.copy_(n_new)
                denom = (beta + torch.sqrt(n_new)) / lr + l2
                # untouched entries (n = 0) take the first branch: z is 0
                w.copy_(torch.where(z.abs() <= l1, torch.zeros_like(z),
                                    -(z - torch.sign(z) * l1) / denom))
        return loss


class OptimizerChain:
    """Steps several optimizers, each over its own parameters, as one."""

    def __init__(self, *optimizers):
        self.optimizers = optimizers

    def step(self):
        for opt in self.optimizers:
            opt.step()
