"""Plain PyTorch NN primitives on explicit parameter dicts.

The twin of the JAX package's ``ops/nn.py``. Parameters are nested dicts of
tensors with the JAX package's names and layouts, so a JAX param tree carries
over leaf for leaf (:mod:`..models.weights`):

* dense kernels are stored ``(in, out)``,
* attention uses a fused qkv projection ``in_kernel`` of shape ``(E, 3E)``
  (columns [0:E) = q, [E:2E) = k, [2E:3E) = v),
* GELU is the exact erf form,
* softmax and layernorm run in fp32 whatever the compute dtype,
* masks are validity masks, True = attend,
* dropout is not here: its one definition, a counter-based mask that kernels
  regenerate, is :func:`.dropout_kernel.dropout_plain`.

These are the plain references the hand-written kernels are held against.
"""

from __future__ import annotations

import math

import torch

Params = dict

# Large negative additive-mask value. Finite (not -inf) so fully-masked rows
# produce a uniform distribution instead of NaNs.
NEG_INF = -1e9


# ---------------------------------------------------------------------------
# initializers (same distributions as the JAX package; the values differ,
# since torch.Generator and jax.random draw different streams). Values are
# drawn in fp32 from the host generator, then cast and moved.
# ---------------------------------------------------------------------------

def _uniform(gen, shape, lo, hi, dtype, device):
    return torch.empty(shape).uniform_(lo, hi, generator=gen) \
        .to(device=device, dtype=dtype)


def trunc_normal(gen, shape, std=0.1, dtype=torch.float32, device="cpu"):
    """torch.nn.init.trunc_normal_ with absolute cutoffs (-2, 2)."""
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, std=std, a=-2.0, b=2.0, generator=gen)
    return t.to(device=device, dtype=dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype=torch.float32,
               device="cpu") -> Params:
    """nn.Linear-equivalent init: U(-1/sqrt(in), 1/sqrt(in)) kernel and bias."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"kernel": _uniform(gen, (in_dim, out_dim), -bound, bound, dtype,
                               device),
            "bias": _uniform(gen, (out_dim,), -bound, bound, dtype, device)}


def layernorm_init(dim: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def embedding_init(gen, vocab_size: int, dim: int, pad_idx: int | None = None,
                   dtype=torch.float32, device="cpu") -> Params:
    """nn.Embedding init: N(0, 1), padding row zeroed."""
    table = torch.randn((vocab_size, dim), generator=gen)
    if pad_idx is not None:
        table[pad_idx] = 0.0
    return {"table": table.to(device=device, dtype=dtype)}


def mha_init(gen, dim: int, dtype=torch.float32, device="cpu") -> Params:
    """nn.MultiheadAttention-equivalent params: xavier-uniform fused in_proj,
    zero biases."""
    limit = math.sqrt(6.0 / (dim + 3 * dim))
    bound = 1.0 / math.sqrt(dim)
    return {
        "in_kernel": _uniform(gen, (dim, 3 * dim), -limit, limit, dtype,
                              device),
        "in_bias": torch.zeros(3 * dim, dtype=dtype, device=device),
        "out": {"kernel": _uniform(gen, (dim, dim), -bound, bound, dtype,
                                   device),
                "bias": torch.zeros(dim, dtype=dtype, device=device)},
    }


# ---------------------------------------------------------------------------
# forward primitives
# ---------------------------------------------------------------------------

def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, params["kernel"].to(x.dtype)) \
        + params["bias"].to(x.dtype)


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 (biased variance), cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def embed(params: Params, idxs: torch.Tensor, dtype=None) -> torch.Tensor:
    """Rows ``idxs`` of the embedding table, in ``dtype`` when given. (The JAX
    package gathers small tables with a one-hot product to spare the TPU a
    scatter-add in the gradient; on an H100 the gather's gradient for the
    (227, 1024) LMX table measured 0.3 ms of a 218 ms training microbatch,
    so the port gathers.)"""
    table = params["table"] if dtype is None else params["table"].to(dtype)
    return table[idxs.long()]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU computed in fp32, cast back to x's dtype."""
    x32 = x.float()
    return (0.5 * x32 * (1.0 + torch.erf(x32 / math.sqrt(2.0)))).to(x.dtype)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, fp32 (scheduled sampling's mix and the sampled
    decode)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32).clamp_min(tiny)
    return -torch.log((-torch.log(u)).clamp_min(tiny))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(..., T, E) -> (..., H, T, Dh)."""
    *lead, t, e = x.shape
    return x.reshape(*lead, t, num_heads, e // num_heads).transpose(-3, -2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., H, T, Dh) -> (..., T, E)."""
    x = x.transpose(-3, -2)
    *lead, t, h, d = x.shape
    return x.reshape(*lead, t, h * d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention with an fp32 softmax.

    q: (B, H, Tq, Dh), k/v: (B, H, Tk, Dh), bias broadcastable to
    (B, H, Tq, Tk), additive in fp32. Returns (B, H, Tq, Dh) in q.dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def valid_to_bias(valid: torch.Tensor) -> torch.Tensor:
    """(B, Tk) bool validity (True = attend) -> (B, 1, 1, Tk) additive bias."""
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, neg)[:, None, None, :]


def causal_bias(t: int, device="cpu") -> torch.Tensor:
    """(1, 1, T, T) additive causal bias."""
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    return torch.where(mask, zero, neg)[None, None]


def mha(params: Params, x_q: torch.Tensor, x_kv: torch.Tensor, num_heads: int,
        bias: torch.Tensor | None = None,
        precomputed_kv: torch.Tensor | None = None) -> torch.Tensor:
    """Full multi-head attention block (fused in-projection, SDPA, out proj).

    ``precomputed_kv``: optional (B, Tk, 2E) already-projected K/V (see
    :func:`.transformer.precompute_memory_kv`); only Q is projected here."""
    e = x_q.shape[-1]
    in_kernel = params["in_kernel"].to(x_q.dtype)
    in_bias = params["in_bias"].to(x_q.dtype)
    if precomputed_kv is not None:
        q = torch.matmul(x_q, in_kernel[:, :e]) + in_bias[:e]
        k, v = precomputed_kv.to(x_q.dtype).split(e, dim=-1)
    elif x_q is x_kv:
        q, k, v = (torch.matmul(x_q, in_kernel) + in_bias).split(e, dim=-1)
    else:
        q = torch.matmul(x_q, in_kernel[:, :e]) + in_bias[:e]
        k, v = (torch.matmul(x_kv, in_kernel[:, e:]) + in_bias[e:]).split(
            e, dim=-1)
    q, k, v = (split_heads(t, num_heads) for t in (q, k, v))
    return dense(params["out"], merge_heads(attention(q, k, v, bias)))
