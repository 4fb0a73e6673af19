"""FTRL-Proximal, AMSGrad and a chain of optimizers over disjoint parameter
sets.

Counterpart of ``librecommender_tpu/training/optimizers.py`` (FTRL-Proximal,
McMahan et al. 2013, for WideDeep's wide part): the same z / n accumulators,
zero-initialised, and the same closed-form proximal step, which sets each
weight to its new value rather than adding a step to it. ``AMSGrad`` is
``optax.amsgrad``, which the JAX package's trainer builds for a model with
``amsgrad=True`` (the graph family).
"""
import torch

from .sparse_optim import _bias_corrections


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


class AMSGrad(torch.optim.Optimizer):
    """optax's AMSGrad: the running maximum of the bias-corrected second
    moment, ``nu_max = max(nu_max, nu / (1 - b2^t))``, and the step
    ``lr * mu_hat / (sqrt(nu_max) + eps)``.

    Not ``torch.optim.Adam(amsgrad=True)``: that keeps the maximum of the
    raw second moment and divides it by ``1 - b2^t`` afterwards, a different
    update wherever the second moment shrinks. The bias corrections are
    float32, as optax computes them."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["count"] = 0
                    for key in ("mu", "nu", "nu_max"):
                        state[key] = torch.zeros_like(p)
                state["count"] += 1
                bc1, bc2 = _bias_corrections(state["count"], b1, b2)
                mu = (1.0 - b1) * g + b1 * state["mu"]
                nu = (1.0 - b2) * torch.square(g) + b2 * state["nu"]
                nu_max = torch.maximum(state["nu_max"], nu / bc2)
                p.add_((mu / bc1) / (torch.sqrt(nu_max) + eps) * -lr)
                state["mu"], state["nu"], state["nu_max"] = mu, nu, nu_max
        return loss


class OptimizerChain:
    """Steps several optimizers, each over its own parameters, as one."""

    def __init__(self, *optimizers):
        self.optimizers = optimizers

    def step(self):
        for opt in self.optimizers:
            opt.step()
