"""The training loop, on one device.

Counterpart of ``make_optimizer`` and ``Trainer`` in
``librecommender_tpu/training/trainer.py``. Per-model behaviour enters
through ``model.loss_fn(params, batch)``; the optimizer, the LR schedule,
negative sampling, the epoch loop, per-epoch evaluation and early stopping
are shared.

On the device: the epoch's row-aligned index arrays are uploaded once per
fit, each epoch's shuffle is a ``torch.randperm`` on the device, device-side
negatives (``sampler="random"``) are drawn there from a generator seeded with
``model.seed``, host-drawn negatives are uploaded once per epoch, and the
step losses stay in a device tensor that is read back once per epoch, so no
step waits for the host. ``model.net`` is one flat mapping of parameters
(nested trees are flattened by the model, see ``bases/feat_base.py``); a
model's row-aligned extras (``batch_extras``: training sequences) ride along
with the epoch arrays. The JAX package's mesh and touched-row gradient
compaction come with the multi-device slice; its checkpoints with the retrain
slice.
"""
import contextlib
import math
import time
from pathlib import Path

import torch

from ..batch import BatchGenerator, adjust_batch_size
from ..evaluation.evaluate import evaluate, print_metrics
from ..utils.misc import colorize, time_block
from .optimizers import AMSGrad
from .sparse_optim import (
    DENSE_UPDATE_MAX_ROWS,
    dense_masked_adam_update,
    init_table_state,
    lazy_adam_update,
)

# negatives redrawn where they hit the positive, after the first draw
NEG_REDRAWS = 4


def lr_factor(lr_decay, n_batches_per_epoch, n_epochs, lr_schedule="exponential"):
    """The LR multiplier at a 0-based step, or None without decay: 0.96 per
    epoch in steps (staircase) or a cosine to 0 over the whole fit, as the
    JAX package's optax schedules (evaluated before the step count moves)."""
    if not lr_decay:
        return None
    if lr_schedule == "cosine":
        steps = max(1, n_batches_per_epoch * n_epochs)
        return lambda s: 0.5 * (1.0 + math.cos(math.pi * min(s, steps) / steps))
    transition = max(1, n_batches_per_epoch)
    return lambda s: 0.96 ** (s // transition)


def make_optimizer(params, lr, lr_decay, epsilon, n_batches_per_epoch, n_epochs,
                   lr_schedule="exponential", amsgrad=False):
    """Adam(eps=epsilon) over ``params``, or with ``amsgrad`` optax's AMSGrad
    (``training/optimizers.py``), and its LR scheduler (None without decay).
    torch's Adam and optax's compute the same update, eps added after the
    bias-corrected square root."""
    optimizer = (AMSGrad(params, lr=lr, eps=epsilon) if amsgrad
                 else torch.optim.Adam(params, lr=lr, eps=epsilon))
    factor = lr_factor(lr_decay, n_batches_per_epoch, n_epochs, lr_schedule)
    scheduler = (None if factor is None
                 else torch.optim.lr_scheduler.LambdaLR(optimizer, factor))
    return optimizer, scheduler


def device_negatives(items, n_items, num_neg, generator):
    """(B, num_neg) uniform negatives; up to NEG_REDRAWS rounds replace those
    equal to the row's positive item."""
    shape = (items.shape[0], num_neg)
    kw = dict(generator=generator, device=items.device, dtype=torch.int32)
    neg = torch.randint(0, n_items, shape, **kw)
    pos = items[:, None]
    for _ in range(NEG_REDRAWS):
        redraw = torch.randint(0, n_items, shape, **kw)
        neg = torch.where(neg == pos, redraw, neg)
    return neg


class Trainer:
    def __init__(
        self,
        model,
        n_epochs,
        lr,
        lr_decay,
        epsilon,
        batch_size,
        sampler,
        num_neg,
        lr_schedule="exponential",
        optimizer=None,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "training on a mesh comes with the multi-device slice (1.16)"
            )
        self.model = model
        if hasattr(model, "_mxu_lookup"):
            # table lookups through the gather and segment-sum kernels for
            # the fit's duration, on the GPU (the per-table size gate lives
            # in FeatBase._train_lookup; post_fit turns it off);
            # _mxu_lookup_force overrides for tests (the plain versions on
            # the CPU)
            force = getattr(model, "_mxu_lookup_force", None)
            model._mxu_lookup = (force if force is not None
                                 else model.device.type == "cuda")
        self.n_epochs = n_epochs
        self.lr = lr
        self.lr_decay = lr_decay
        self.epsilon = epsilon
        # batch_size counts all examples of a step, negatives included
        self.batch_size = adjust_batch_size(model, batch_size)
        self.sampler = sampler
        self.num_neg = num_neg
        self.lr_schedule = lr_schedule
        # a model's own optimizer: a callable taking the parameters
        self.optimizer = optimizer
        self.epoch_times = []
        self.epoch_losses = []

    def _tables(self):
        """(lazy-Adam tables, whether they take the dense masked pass)."""
        model = self.model
        if not getattr(model, "sparse_optimizer", False):
            return (), False
        tables = tuple(getattr(model, "sparse_tables", ()))
        mode = getattr(model, "sparse_update_mode", "auto")
        if mode not in ("auto", "rows", "dense"):
            raise ValueError(f"sparse_update_mode must be auto, rows or dense, "
                             f"got {mode!r}")
        if mode == "auto":
            dense = all(model.net[k].shape[0] <= DENSE_UPDATE_MAX_ROWS
                        for k in tables)
        else:
            dense = mode == "dense"
        return tables, dense

    def _rest_optimizer(self, params, n_batches):
        if self.optimizer is not None:
            return self.optimizer(params), None
        if isinstance(self.lr, dict):
            raise ValueError("a dict `lr` requires a model-supplied optimizer")
        return make_optimizer(params, self.lr, self.lr_decay, self.epsilon,
                              n_batches, self.n_epochs, self.lr_schedule,
                              amsgrad=getattr(self.model, "amsgrad", False))

    def run(
        self,
        train_data,
        neg_sampling,
        verbose,
        shuffle,
        eval_data,
        metrics,
        k=10,
        eval_batch_size=8192,
        eval_user_num=None,
        profile_dir=None,
        checkpoint_dir=None,
        early_stopping=None,
    ):
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "fit checkpoints come with the retrain slice (1.14)"
            )
        if early_stopping:
            if eval_data is None:
                raise ValueError("early_stopping requires eval_data")
            es_metric = (metrics or ["loss"])[0]
            # lower-is-better metrics; everything else is higher-is-better
            es_lower = es_metric in ("loss", "rmse", "mae", "log_loss")
            es_best, es_best_params, es_bad = None, None, 0

        model = self.model
        device = model.device
        params = model.net
        generator = BatchGenerator(
            train_data,
            model.data_info,
            self.batch_size,
            paradigm=model.paradigm,
            neg_sampling=neg_sampling,
            sampler=self.sampler,
            num_neg=self.num_neg,
            seed=model.seed,
            extras=model.batch_extras(train_data),
        )
        n_batches = generator.n_batches()
        bs = self.batch_size
        tables, dense_tables = self._tables()
        # the tables' rate stays constant: the JAX package's lazy Adam takes
        # the raw lr, so lr_decay moves only the other parameters
        sparse_lr = self.lr if not isinstance(self.lr, dict) else 1e-3
        table_state = init_table_state(params, tables) if tables else None
        rest_keys = [key for key in params.keys() if key not in tables]
        optimizer = scheduler = None
        if rest_keys:
            optimizer, scheduler = self._rest_optimizer(
                [params[key] for key in rest_keys], n_batches)

        data = {key: torch.from_numpy(v).to(device)
                for key, v in generator.epoch_arrays().items()}
        rng = torch.Generator(device=device).manual_seed(model.seed)
        keys = list(params.keys())

        def step(batch):
            loss = model.loss_fn(params, batch)
            # a parameter the loss does not reach (the last MLP layer's
            # unused norm) gets a zero gradient, as under jax.grad
            grads = dict(zip(keys, torch.autograd.grad(
                loss, [params[key] for key in keys], materialize_grads=True)))
            if dense_tables:
                dense_masked_adam_update(params, grads, table_state, tables,
                                         sparse_lr, eps=self.epsilon)
            elif tables:
                touched = {key: v for key, v in model.touched_indices(batch).items()
                           if key in tables}
                lazy_adam_update(params, grads, table_state, touched, sparse_lr,
                                 eps=self.epsilon)
            if optimizer is not None:
                for key in rest_keys:
                    params[key].grad = grads[key]
                optimizer.step()
                if scheduler is not None:
                    scheduler.step()
            return loss.detach()

        self.epoch_times, self.epoch_losses = [], []
        for epoch in range(1, self.n_epochs + 1):
            if verbose > 0 and self.lr_decay:
                print(f"With lr_decay, epoch {epoch} start...")
            epoch_start = time.perf_counter()
            trace = profile_dir is not None and epoch == 2
            with time_block(f"Epoch {epoch}", verbose), _profiled(trace, device) as prof:
                host_negs = generator.epoch_negatives()
                negs = (None if host_negs is None
                        else torch.from_numpy(host_negs).to(device))
                perm = (torch.randperm(n_batches * bs, generator=rng, device=device)
                        if shuffle else None)
                losses = torch.empty(n_batches, device=device)
                for i in range(n_batches):
                    rows = (perm[i * bs:(i + 1) * bs] if shuffle
                            else slice(i * bs, (i + 1) * bs))
                    batch = {key: v[rows] for key, v in data.items()}
                    if generator.device_side_sampling:
                        batch["item_neg"] = device_negatives(
                            batch["item"], model.n_items, self.num_neg, rng)
                    elif negs is not None:
                        batch["item_neg"] = negs[rows]
                    losses[i] = step(batch)
                # the epoch's one read-back: the card finishes the epoch here
                losses = losses.cpu()
            if prof is not None:
                Path(profile_dir).mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(Path(profile_dir) / "epoch2_trace.json"))
                if verbose > 0:
                    print(colorize(f"profile written to {profile_dir}", "cyan"))
            self.epoch_times.append(time.perf_counter() - epoch_start)
            self.epoch_losses.append(float(losses.mean()))
            if verbose > 0:
                print(f"\t train_loss: {self.epoch_losses[-1]:.4f}")

            if verbose > 1:
                model.post_epoch()
                print_metrics(
                    model,
                    eval_data=eval_data,
                    metrics=metrics,
                    eval_batch_size=eval_batch_size,
                    k=k,
                    sample_user_num=eval_user_num,
                    seed=model.seed,
                    neg_sampling=neg_sampling,
                )
                print("=" * 30)

            if early_stopping:
                model.post_epoch()
                val = evaluate(
                    model, eval_data, neg_sampling=neg_sampling,
                    metrics=[es_metric], k=k,
                    sample_user_num=eval_user_num, seed=model.seed,
                )[es_metric]
                improved = es_best is None or (
                    val < es_best if es_lower else val > es_best
                )
                if improved:
                    es_best, es_bad = val, 0
                    es_best_params = {key: p.detach().clone()
                                      for key, p in params.items()}
                else:
                    es_bad += 1
                    if es_bad >= early_stopping:
                        if verbose > 0:
                            print(colorize(
                                f"early stop at epoch {epoch}: {es_metric} "
                                f"best {es_best:.4f}, no improvement for "
                                f"{early_stopping} epochs", "cyan",
                            ))
                        break

        if early_stopping and es_best_params is not None:
            # keep the best-seen parameters, stopped early or not
            with torch.no_grad():
                for key, p in params.items():
                    p.copy_(es_best_params[key])


@contextlib.contextmanager
def _profiled(enabled, device):
    """A ``torch.profiler`` session (CPU, and CUDA on a GPU) when enabled."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
