"""Stacked post-norm transformer blocks (the twin of the JAX package's
``ops/transformer.py``).

Each stack's parameters are one dict whose leaves carry a leading
``num_layers`` axis, as in the JAX package. Post-norm layers, exact GELU,
LayerNorm eps 1e-5.

:func:`encoder_layer` / :func:`decoder_layer` are the plain per-layer
references. The inference encoder stack is
:func:`.encoder_stack_kernel.encoder_stack_fused`, whose ops launch the
hand-written kernels on CUDA tensors; the decoder stack here backs the
teacher-forced :func:`..models.omr_decoder.forward`, the CPU oracle of the
cached decode.
"""

from __future__ import annotations

import torch

from . import nn

Params = dict


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def encoder_layer_init(gen, dim: int, mlp_dim: int, dtype=torch.float32,
                       device="cpu") -> Params:
    return {
        "self_attn": nn.mha_init(gen, dim, dtype, device),
        "norm1": nn.layernorm_init(dim, dtype, device),
        "linear1": nn.dense_init(gen, dim, mlp_dim, dtype, device),
        "linear2": nn.dense_init(gen, mlp_dim, dim, dtype, device),
        "norm2": nn.layernorm_init(dim, dtype, device),
    }


def decoder_layer_init(gen, dim: int, mlp_dim: int, dtype=torch.float32,
                       device="cpu") -> Params:
    return {
        "self_attn": nn.mha_init(gen, dim, dtype, device),
        "norm1": nn.layernorm_init(dim, dtype, device),
        "cross_attn": nn.mha_init(gen, dim, dtype, device),
        "norm2": nn.layernorm_init(dim, dtype, device),
        "linear1": nn.dense_init(gen, dim, mlp_dim, dtype, device),
        "linear2": nn.dense_init(gen, mlp_dim, dim, dtype, device),
        "norm3": nn.layernorm_init(dim, dtype, device),
    }


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stack_init(layer_init, gen, num_layers: int, *args, **kwargs) -> Params:
    """Init ``num_layers`` layers and stack leaves along a leading axis."""
    return _stack([layer_init(gen, *args, **kwargs) for _ in range(num_layers)])


def layer_slice(stacked: Params, i: int) -> Params:
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def num_stacked_layers(stacked: Params) -> int:
    return stacked["norm1"]["scale"].shape[0]


# ---------------------------------------------------------------------------
# single-layer forwards (post-norm, plain PyTorch)
# ---------------------------------------------------------------------------

def encoder_layer(params: Params, x: torch.Tensor, bias, num_heads: int):
    """x = norm1(x + SA(x)); x = norm2(x + FF(x)). bias: additive attn bias."""
    sa = nn.mha(params["self_attn"], x, x, num_heads, bias)
    x = nn.layernorm(params["norm1"], x + sa, eps=1e-5)
    h = nn.dense(params["linear2"], nn.gelu(nn.dense(params["linear1"], x)))
    return nn.layernorm(params["norm2"], x + h, eps=1e-5)


def decoder_layer(params: Params, x: torch.Tensor, memory: torch.Tensor,
                  self_bias, cross_bias, num_heads: int) -> torch.Tensor:
    """Post-norm decoder layer: SA -> norm1, CA -> norm2, FF -> norm3."""
    sa = nn.mha(params["self_attn"], x, x, num_heads, self_bias)
    x = nn.layernorm(params["norm1"], x + sa, eps=1e-5)
    ca = nn.mha(params["cross_attn"], x, memory, num_heads, cross_bias)
    x = nn.layernorm(params["norm2"], x + ca, eps=1e-5)
    h = nn.dense(params["linear2"], nn.gelu(nn.dense(params["linear1"], x)))
    return nn.layernorm(params["norm3"], x + h, eps=1e-5)


# ---------------------------------------------------------------------------
# stacked forwards
# ---------------------------------------------------------------------------

def encoder_stack_layers(stacked: Params, x: torch.Tensor,
                         valid: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The same stack as a loop of plain :func:`encoder_layer` calls."""
    bias = nn.valid_to_bias(valid)
    for i in range(num_stacked_layers(stacked)):
        x = encoder_layer(layer_slice(stacked, i), x, bias, num_heads)
    return x


def decoder_stack(stacked: Params, x: torch.Tensor, memory: torch.Tensor,
                  self_bias, cross_bias, num_heads: int) -> torch.Tensor:
    """Plain decoder stack (teacher-forced forward)."""
    for i in range(num_stacked_layers(stacked)):
        x = decoder_layer(layer_slice(stacked, i), x, memory, self_bias,
                          cross_bias, num_heads)
    return x
