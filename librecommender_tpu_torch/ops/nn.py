"""Neural-net building blocks as init/apply function pairs on tensors.

Counterpart of ``librecommender_tpu/ops/nn.py``: dense, mlp, dropout, layer
and RMS norm, the DIN attention unit, multi-head attention, the pre-LN
transformer layer and its target-position form, the sinusoidal positions, the
GRU and LSTM recurrences and the (causal, dilated) 1-D convolution.

Conventions
-----------
- ``init_*`` takes a ``torch.Generator`` (whose device the parameters land
  on) and sizes, and returns a dict of tensors with the JAX package's keys.
- apply functions are pure; dropout takes an explicit generator and a
  ``train`` flag.
- The matrix products are ``torch.matmul``: float32, no TF32 unless the
  caller turned it on. The convolutions (``conv1d``) and the graph
  propagation's products (``float32_matmul``) are float32 whatever the
  caller's setting.
"""
import contextlib
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from .initializers import he_init, truncated_normal


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


def init_rms_norm(dim, device=None):
    return {"scale": torch.ones((dim,), device=device)}


def rms_norm(params, x, eps=1e-6):
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * params["scale"]


def l2_normalize(x, dim=-1, eps=1e-8):
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


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


# the value a masked logit takes before the softmax (JAX's): a row whose keys
# are all masked gets uniform weights, not the NaN of a softmax over -inf
MASKED_LOGIT = -1e9


@functools.lru_cache(maxsize=None)
def _root(d, dtype):
    """sqrt(d) rounded to ``dtype``: the JAX package divides the logits by
    ``jnp.sqrt(d).astype(q.dtype)``. Rounded with numpy, not through a
    tensor: under ``torch.export`` a tensor made here is traced, and its
    value is not known."""
    root = np.float32(d ** 0.5)
    if dtype == torch.bfloat16:   # round to nearest even, 16 bits kept
        bits = int(root.view(np.uint32))
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        root = np.uint32(bits).view(np.float32)
    elif dtype == torch.float16:
        root = np.float16(root)
    return float(root)


def init_mha(generator, embed_dim, num_heads, head_dim=None):
    """Multi-head attention: ``wq``, ``wk``, ``wv`` (D, H * dh), ``wo``."""
    head_dim = head_dim or embed_dim // num_heads
    inner = num_heads * head_dim
    return {
        "wq": truncated_normal(generator, (embed_dim, inner), scale=embed_dim ** -0.5),
        "wk": truncated_normal(generator, (embed_dim, inner), scale=embed_dim ** -0.5),
        "wv": truncated_normal(generator, (embed_dim, inner), scale=embed_dim ** -0.5),
        "wo": truncated_normal(generator, (inner, embed_dim), scale=inner ** -0.5),
    }


def mha(params, queries, keys, mask=None, causal=False, num_heads=1):
    """queries (B, Lq, D); keys (B, Lk, D); mask (B, Lk) bool -> (B, Lq, D).

    One form for every window: the JAX package's separate small-window form
    (``Lq * Lk <= SMALL_ATTENTION_MAX``) is a TPU layout choice with the same
    maths. Self-attention (``queries is keys``) projects q, k and v with one
    matmul of the concatenated weights, as the JAX package does. Masked
    logits take ``MASKED_LOGIT``; the weights are cast to the values' dtype
    after the softmax."""
    H = num_heads
    B, Lq, D = queries.shape
    Lk = keys.shape[1]
    dt = queries.dtype
    if queries is keys:
        w_qkv = torch.cat([params["wq"], params["wk"], params["wv"]], dim=1).to(dt)
        qkv = queries.reshape(B * Lq, D) @ w_qkv             # (B*L, 3*inner)
        inner = w_qkv.shape[1] // 3
        q = qkv[:, :inner].reshape(B, Lq, H, -1)
        k = qkv[:, inner:2 * inner].reshape(B, Lk, H, -1)
        v = qkv[:, 2 * inner:].reshape(B, Lk, H, -1)
    else:
        q = (queries.reshape(B * Lq, D) @ params["wq"].to(dt)).reshape(B, Lq, H, -1)
        k = (keys @ params["wk"].to(keys.dtype)).reshape(B, Lk, H, -1)
        v = (keys @ params["wv"].to(keys.dtype)).reshape(B, Lk, H, -1)
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / _root(d, q.dtype)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits, MASKED_LOGIT)
    if causal:
        tril = torch.ones((Lq, Lk), dtype=torch.bool, device=logits.device).tril()
        logits = torch.where(tril[None, None], logits, MASKED_LOGIT)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B * Lq, -1)
    return (out @ params["wo"].to(out.dtype)).reshape(B, Lq, -1)


# -------------------------------------------------------------- transformer
def init_transformer_layer(generator, embed_dim, num_heads, ffn_dim):
    """Pre-LN encoder layer."""
    device = generator.device
    return {
        "mha": init_mha(generator, embed_dim, num_heads),
        "ln1": init_layer_norm(embed_dim, device),
        "ln2": init_layer_norm(embed_dim, device),
        "ffn1": init_dense(generator, embed_dim, ffn_dim),
        "ffn2": init_dense(generator, ffn_dim, embed_dim),
    }


def transformer_layer(params, x, mask=None, causal=False, num_heads=1):
    """x (B, L, D) -> (B, L, D): x + mha(ln1(x)), then + ffn(ln2(.))."""
    B, L, D = x.shape
    xf = x.reshape(B * L, D)
    h = layer_norm(params["ln1"], xf).reshape(B, L, D)
    att = mha(params["mha"], h, h, mask=mask, causal=causal, num_heads=num_heads)
    xf = xf + att.reshape(B * L, D)
    h = layer_norm(params["ln2"], xf)
    h = dense(params["ffn2"], F.relu(dense(params["ffn1"], h)))
    return (xf + h).reshape(B, L, D)


def transformer_target_out(layers, seq_x, seq_mask, tgt_x, num_heads=1,
                           causal=False):
    """Pre-LN encoder stack output at the target position only.

    The target is appended to the behavior sequence and only its output is
    read. Where the sequence tokens' outputs do not depend on the target (one
    layer, whose sequence outputs are never read, or a causal mask with the
    target last) they are computed once and shared by all T target blocks:
    per layer the sequence rows need only their K/V projections, and the
    Q/K/V, attention and FFN run on the (T, B) target rows alone.

    layers: list of ``init_transformer_layer`` params. seq_x (B, L, D);
    seq_mask (B, L) bool; tgt_x (T, B, D). Returns (T, B, D), equal to
    ``transformer_layer`` over [seq, target] at the last position under the
    stated conditions; raises ValueError otherwise.
    """
    if len(layers) > 1 and not causal:
        raise ValueError(
            "shared-seq target output is exact only for 1 layer or with "
            "causal masking"
        )
    H = num_heads
    T, B, D = tgt_x.shape
    L = seq_x.shape[1]
    x_seq, x_tgt = seq_x, tgt_x
    for li, layer in enumerate(layers):
        p = layer["mha"]
        inner = p["wq"].shape[1]
        d = inner // H
        dt = x_seq.dtype
        wq = p["wq"].to(dt).reshape(D, H, d)
        wk = p["wk"].to(dt).reshape(D, H, d)
        wv = p["wv"].to(dt).reshape(D, H, d)
        wo = p["wo"].to(dt).reshape(H, d, D)
        h_seq = layer_norm(layer["ln1"], x_seq)                # (B, L, D)
        k_seq = torch.einsum("bld,dhe->blhe", h_seq, wk)
        v_seq = torch.einsum("bld,dhe->blhe", h_seq, wv)
        h_tgt = layer_norm(layer["ln1"], x_tgt)                # (T, B, D)
        q_t = torch.einsum("abd,dhe->abhe", h_tgt, wq)
        k_t = torch.einsum("abd,dhe->abhe", h_tgt, wk)
        v_t = torch.einsum("abd,dhe->abhe", h_tgt, wv)
        scale = _root(d, q_t.dtype)
        logit_seq = torch.einsum("tbhd,blhd->tbhl", q_t, k_seq) / scale
        logit_seq = torch.where(seq_mask[None, :, None, :], logit_seq, MASKED_LOGIT)
        logit_self = torch.sum(q_t * k_t, dim=-1)[..., None] / scale
        weights = torch.softmax(
            torch.cat([logit_seq, logit_self], dim=-1), dim=-1
        ).to(v_t.dtype)                                        # (T, B, H, L+1)
        att = (torch.einsum("tbhl,blhd->tbhd", weights[..., :L], v_seq)
               + weights[..., L:] * v_t)
        xf = x_tgt + torch.einsum("abhd,hde->abe", att, wo)
        h2 = layer_norm(layer["ln2"], xf)
        h2 = dense(layer["ffn2"], F.relu(dense(layer["ffn1"], h2)))
        x_tgt = xf + h2
        if li < len(layers) - 1:
            # causal only: the sequence tokens attend among themselves as in
            # the full pass (tril(L + 1)'s top-left block is tril(L))
            x_seq = transformer_layer(layer, x_seq, mask=seq_mask, causal=True,
                                      num_heads=H)
    return x_tgt


def positional_encoding(seq_len, dim, device=None):
    """Sinusoidal positions (seq_len, dim): sin on even columns, cos on odd."""
    pos = torch.arange(seq_len, device=device, dtype=torch.float32)[:, None]
    col = torch.arange(dim, device=device)
    i = col[None, :].to(torch.float32)
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            (2.0 * torch.floor(i / 2.0)) / dim)
    return torch.where(col[None, :] % 2 == 0, torch.sin(angle), torch.cos(angle))


# ---------------------------------------------------------------- recurrent
# The recurrences are loops over the sequence of plain tensor ops, the input
# projection hoisted out of the loop as in the JAX package. torch.nn.GRU and
# LSTM (and cuDNN) compute other functions: their GRU puts a second bias
# inside the reset gate's product, and their gates come in another order.
def init_gru(generator, in_dim, hidden_dim):
    return {
        "wi": truncated_normal(generator, (in_dim, 3 * hidden_dim),
                               scale=in_dim ** -0.5),
        "wh": truncated_normal(generator, (hidden_dim, 3 * hidden_dim),
                               scale=hidden_dim ** -0.5),
        "b": torch.zeros((3 * hidden_dim,), device=generator.device),
    }


def gru(params, x, mask=None, h0=None):
    """GRU over (B, L, D_in) -> final hidden (B, H) and all states (B, L, H).

    One bias, on the input side: ``n = tanh(x_n + r * (h @ wh_n))``. A masked
    step (``mask`` (B, L) bool False) keeps the previous state, so a
    left-padded sequence ends at the state of its true last step.
    """
    B, L, D = x.shape
    H = params["wh"].shape[0]
    h = x.new_zeros((B, H)) if h0 is None else h0
    gates_x = (x.reshape(B * L, D) @ params["wi"] + params["b"]).reshape(B, L, 3 * H)
    states = []
    for t in range(L):
        xr, xz, xn = gates_x[:, t].split(H, dim=-1)
        hr, hz, hn = (h @ params["wh"]).split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        h = h_new if mask is None else torch.where(mask[:, t, None], h_new, h)
        states.append(h)
    return h, torch.stack(states, dim=1)


def init_lstm(generator, in_dim, hidden_dim):
    return {
        "wi": truncated_normal(generator, (in_dim, 4 * hidden_dim),
                               scale=in_dim ** -0.5),
        "wh": truncated_normal(generator, (hidden_dim, 4 * hidden_dim),
                               scale=hidden_dim ** -0.5),
        "b": torch.zeros((4 * hidden_dim,), device=generator.device),
    }


def lstm(params, x, mask=None):
    """LSTM over (B, L, D_in) -> final hidden (B, H) and the unmasked step
    outputs (B, L, H). Gates in the order i, f, g, o, no forget-gate offset;
    a masked step keeps the previous hidden and cell state."""
    B, L, D = x.shape
    H = params["wh"].shape[0]
    h = c = x.new_zeros((B, H))
    gates_x = (x.reshape(B * L, D) @ params["wi"] + params["b"]).reshape(B, L, 4 * H)
    outputs = []
    for t in range(L):
        i, f, g, o = (gates_x[:, t] + h @ params["wh"]).split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if mask is None:
            h, c = h_new, c_new
        else:
            keep = mask[:, t, None]
            h, c = torch.where(keep, h_new, h), torch.where(keep, c_new, c)
        outputs.append(h_new)
    return h, torch.stack(outputs, dim=1)


# ------------------------------------------------------------ convolutional
def init_conv1d(generator, kernel_size, in_ch, out_ch):
    """``w`` (kernel_size, in_ch, out_ch), the JAX package's WIO layout."""
    return {
        "w": he_init(generator, (kernel_size, in_ch, out_ch),
                     fan_in=kernel_size * in_ch),
        "b": torch.zeros((out_ch,), device=generator.device),
    }


_CUDNN_FLAG = threading.Lock()


@contextlib.contextmanager
def cudnn_float32():
    """cuDNN's TF32 off while a convolution runs, the caller's setting back
    after it (PyTorch's default turns it on)."""
    with _CUDNN_FLAG:
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = before


class _Conv1d(torch.autograd.Function):
    """``F.conv1d`` (NCW, OIW, no bias) with its forward and its backward
    under ``cudnn_float32``: autograd's own backward would read the global
    flag when it runs, not when the forward ran."""

    @staticmethod
    def forward(ctx, x, w, dilation):
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        with cudnn_float32():
            return F.conv1d(x, w, dilation=dilation)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        with cudnn_float32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad, x, w, None, [1], [0], [ctx.dilation], False, [0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None


def conv1d(params, x, padding="VALID", dilation=1):
    """x (B, L, C_in) -> (B, L', C_out), a cross-correlation (the kernel is
    not flipped) as ``lax.conv_general_dilated`` computes it; ``padding``
    "VALID" or "SAME" (lax's split: the odd pad on the right).

    Runs ``torch.nn.functional.conv1d`` in its NCW/OIW layout. On the GPU
    that is cuDNN, held to float32 in both directions, as lax's convolution
    computes, whatever ``torch.backends.cudnn.allow_tf32`` says."""
    w = params["w"]
    if padding == "SAME":
        total = dilation * (w.shape[0] - 1)
        x = F.pad(x, (0, 0, total // 2, total - total // 2))
    elif padding != "VALID":
        raise ValueError(f"padding must be VALID or SAME, got {padding!r}")
    out = _Conv1d.apply(x.transpose(1, 2), w.permute(2, 1, 0), dilation)
    return out.transpose(1, 2) + params["b"]


def causal_conv1d(params, x, dilation=1):
    """Left-padded dilated conv (WaveNet): output t sees inputs <= t."""
    pad = dilation * (params["w"].shape[0] - 1)
    return conv1d(params, F.pad(x, (0, 0, pad, 0)), dilation=dilation)


# ------------------------------------------------------------ float32 matmul
_MATMUL_FLAG = threading.Lock()


@contextlib.contextmanager
def _matmul_float32():
    """cuBLAS's TF32 off while a product runs, the caller's setting back
    after it."""
    with _MATMUL_FLAG:
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before


class _Float32Matmul(torch.autograd.Function):
    """``a @ b`` with its forward and its backward under ``_matmul_float32``
    (autograd's own backward reads the flag when it runs)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _matmul_float32():
            return a @ b

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        da = db = None
        with _matmul_float32():
            if ctx.needs_input_grad[0]:
                da = grad @ b.T
            if ctx.needs_input_grad[1]:
                db = a.T @ grad
        return da, db


def float32_matmul(a, b):
    """(M, K) @ (K, N) in float32 in both directions, whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says: the dense graph
    propagation (LightGCN, NGCF), as the JAX package's products compute."""
    return _Float32Matmul.apply(a, b)
