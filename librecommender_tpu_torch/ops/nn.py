"""Neural-net building blocks as init/apply function pairs on tensors.

Counterpart of the part of ``librecommender_tpu/ops/nn.py`` that DIN runs:
dense, mlp, dropout, layer norm and the DIN attention unit. Multi-head
attention, the transformer block, the recurrent and the convolutional layers
come with the models that use them.

Conventions
-----------
- ``init_*`` takes a ``torch.Generator`` (whose device the parameters land
  on) and sizes, and returns a dict of tensors with the JAX package's keys.
- apply functions are pure; dropout takes an explicit generator and a
  ``train`` flag.
- The matrix products are ``torch.matmul``: float32, no TF32 unless the
  caller turned it on.
"""
import torch
import torch.nn.functional as F

from .initializers import he_init


# ----------------------------------------------------------------- dense
def init_dense(generator, in_dim, out_dim):
    return {
        "w": he_init(generator, (in_dim, out_dim), fan_in=in_dim),
        "b": torch.zeros((out_dim,), device=generator.device),
    }


def dense(params, x):
    return x @ params["w"] + params["b"]


ACTIVATIONS = {
    "relu": F.relu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
    None: lambda x: x,
}


def init_mlp(generator, in_dim, hidden_units, use_ln=False):
    """MLP stack: ``{"layers": [{"dense": ..., "ln": ...}, ...]}``."""
    layers = []
    dims = [in_dim, *hidden_units]
    for i in range(len(hidden_units)):
        layer = {"dense": init_dense(generator, dims[i], dims[i + 1])}
        if use_ln:
            layer["ln"] = init_layer_norm(dims[i + 1], generator.device)
        layers.append(layer)
    return {"layers": layers}


def mlp(params, x, activation="relu", dropout_rate=0.0, train=False,
        generator=None, final_activation=True):
    act = ACTIVATIONS[activation]
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x = dense(layer["dense"], x)
        is_last = i == n - 1
        if not is_last or final_activation:
            if "ln" in layer:
                x = layer_norm(layer["ln"], x)
            x = act(x)
            if train and dropout_rate > 0.0:
                x = dropout(x, dropout_rate, generator)
    return x


def dropout(x, rate, generator):
    """Inverted dropout; the mask is drawn from ``generator`` on x's device."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


# ------------------------------------------------------------- normalization
def init_layer_norm(dim, device=None):
    return {"scale": torch.ones((dim,), device=device),
            "bias": torch.zeros((dim,), device=device)}


def layer_norm(params, x, eps=1e-6):
    """Layer norm with the biased variance and ``rsqrt(var + 1e-6)``, written
    out: ``torch.nn.functional.layer_norm`` defaults to 1e-5."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    normed = (x - mean) * torch.rsqrt(var + eps)
    return normed * params["scale"] + params["bias"]


# ---------------------------------------------------------------- attention
def init_din_attention(generator, embed_dim, hidden_units=(36,)):
    """DIN local-activation unit: an MLP over [k, q, k - q, k * q] per
    history position, then one logit."""
    m = init_mlp(generator, 4 * embed_dim, list(hidden_units))
    out = init_dense(generator, hidden_units[-1], 1)
    return {"mlp": m, "out": out}


def din_attention(params, queries, keys, mask):
    """queries (B, D) or (T, B, D); keys (B, L, D); mask (B, L) bool
    -> (B, D) / (T, B, D).

    The first MLP layer acts on [k, q, k-q, k*q] per position; the concat is
    never materialized: the (4D, H) weight splits into four (D, H) blocks and
    the q-terms fold to a single per-row matmul,
        h = k@(w_k + w_d) + q@(w_q - w_d) + (k*q)@w_p + b.
    The (T, B, D) form scores T targets against one shared key set per row:
    positives and sampled negatives share the row's history, so the history's
    gather, its k-term and the backward scatter-add into the item table run
    once per row, not once per target.

    A row whose mask is all False (a cold user, a user's first interaction)
    gives a softmax over -inf, which is NaN; the ``where`` after it zeroes the
    value and, in this order, the backward's selects drop the NaN too.
    """
    single = queries.dim() == 2
    if single:
        queries = queries[None]                          # (1, B, D)
    layers = params["mlp"]["layers"]
    first = layers[0]
    D = keys.shape[-1]
    w = first["dense"]["w"]                              # (4D, H)
    w_k, w_q, w_d, w_p = w[:D], w[D:2 * D], w[2 * D:3 * D], w[3 * D:]
    term_q = queries @ (w_q - w_d)                       # (T, B, H)
    term_k = keys @ (w_k + w_d)                          # (B, L, H) shared
    term_p = (keys[None] * queries[:, :, None, :]) @ w_p  # (T, B, L, H)
    h = term_k[None] + term_p + term_q[:, :, None, :] + first["dense"]["b"]
    if "ln" in first:
        h = layer_norm(first["ln"], h)
    h = torch.sigmoid(h)
    if len(layers) > 1:
        h = mlp({"layers": layers[1:]}, h, activation="sigmoid")
    logits = dense(params["out"], h)[..., 0]             # (T, B, L)
    neg_inf = torch.full((), float("-inf"), dtype=logits.dtype,
                         device=logits.device)
    logits = torch.where(mask[None], logits, neg_inf)
    weights = torch.softmax(logits, dim=-1)
    weights = torch.where(mask.any(dim=1)[None, :, None], weights,
                          torch.zeros((), dtype=weights.dtype,
                                      device=weights.device))
    out = torch.einsum("tbl,bld->tbd", weights, keys)
    return out[0] if single else out
