"""Stacked post-norm transformer blocks (the twin of the JAX package's
``ops/transformer.py``).

Each stack's parameters are one dict whose leaves carry a leading
``num_layers`` axis, as in the JAX package. Post-norm layers, exact GELU,
LayerNorm eps 1e-5.

:func:`encoder_stack` and :func:`decoder_stack` are what the models call:
on CUDA tensors they run the fused stacks of :mod:`.train_layer_kernel`
(hand-written kernels, forward and backward), on CPU tensors the same
sequence of plain twins under autograd. :func:`encoder_layer` /
:func:`decoder_layer` and the ``*_stack_layers`` loops over them are the
independent per-layer references (no dropout) the tests hold both against.
"""

from __future__ import annotations

import contextlib

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


def stack_slice(stacked: Params, lo: int, hi: int) -> Params:
    """Sub-stack [lo, hi) of a stacked layer tree (the frozen / fine-tune
    split of the encoder)."""
    return {k: stack_slice(v, lo, hi) if isinstance(v, dict) else v[lo:hi]
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
                  self_bias, cross_bias, num_heads: int,
                  mem_kv: torch.Tensor | None = None,
                  cross_group: int = 1) -> torch.Tensor:
    """Post-norm decoder layer: SA -> norm1, CA -> norm2, FF -> norm3.
    ``mem_kv``: optional (B, Tm, 2E) precomputed cross K/V of this layer.
    ``cross_group=G``: x's rows are G contiguous rows per memory row (GRPO's
    rollouts of one image); memory / mem_kv / cross_bias carry the B/G unique
    rows and the G rows fold into the cross-attention's query axis."""
    sa = nn.mha(params["self_attn"], x, x, num_heads, self_bias)
    x = nn.layernorm(params["norm1"], x + sa, eps=1e-5)
    r, t, e = x.shape
    xq = x.reshape(r // cross_group, cross_group * t, e)
    ca = nn.mha(params["cross_attn"], xq, memory, num_heads, cross_bias,
                precomputed_kv=mem_kv).reshape(r, t, e)
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


def decoder_stack_layers(stacked: Params, x: torch.Tensor,
                         memory: torch.Tensor, self_bias, cross_bias,
                         num_heads: int,
                         mem_kv: torch.Tensor | None = None,
                         cross_group: int = 1) -> torch.Tensor:
    """The decoder stack as a loop of plain :func:`decoder_layer` calls."""
    for i in range(num_stacked_layers(stacked)):
        x = decoder_layer(layer_slice(stacked, i), x, memory, self_bias,
                          cross_bias, num_heads,
                          None if mem_kv is None else mem_kv[i], cross_group)
    return x


def precompute_memory_kv(stacked: Params, memory: torch.Tensor) -> torch.Tensor:
    """All layers' cross-attention K/V projections of ``memory`` (B, Tm, E)
    in one batched product -> (L, B, Tm, 2E) in memory's dtype. Scheduled
    sampling's two decoder passes share it. Plain PyTorch under autograd,
    as the JAX package leaves this product outside its kernels."""
    e = memory.shape[-1]
    kern = stacked["cross_attn"]["in_kernel"][:, :, e:].to(memory.dtype)
    bias = stacked["cross_attn"]["in_bias"][:, e:].to(memory.dtype)
    kv = torch.einsum("bte,lef->lbtf", memory, kern)
    return kv + bias[:, None, None, :]


_PLAIN_TWINS = False


@contextlib.contextmanager
def plain_twins():
    """Within the block :func:`encoder_stack` and :func:`decoder_stack` run
    the plain twins under autograd on any device: the yardstick the kernel
    path is held against on the card."""
    global _PLAIN_TWINS
    before, _PLAIN_TWINS = _PLAIN_TWINS, True
    try:
        yield
    finally:
        _PLAIN_TWINS = before


def encoder_stack(stacked: Params, x: torch.Tensor, valid: torch.Tensor,
                  num_heads: int, dropout_rate: float = 0.0, seeds=None,
                  deterministic: bool = True) -> torch.Tensor:
    """The encoder stack, x (B, T, E), valid (B, T) bool: the fused kernels
    on CUDA tensors, their plain twins under autograd on CPU tensors."""
    from . import train_layer_kernel
    return train_layer_kernel.encoder_stack_fused(
        stacked, x, valid, num_heads, dropout_rate, seeds, deterministic,
        plain=_PLAIN_TWINS or x.device.type == "cpu")


def decoder_stack(stacked: Params, x: torch.Tensor, mem_kv: torch.Tensor,
                  self_valid: torch.Tensor, mem_valid: torch.Tensor,
                  num_heads: int, dropout_rate: float = 0.0, seeds=None,
                  deterministic: bool = True,
                  cross_group: int = 1) -> torch.Tensor:
    """The decoder stack over precomputed cross K/V ``mem_kv``
    (L, B, Tm, 2E): the fused kernels on CUDA tensors, their plain twins
    under autograd on CPU tensors. ``cross_group=G``: x carries G contiguous
    rows per row of mem_kv / mem_valid; the projected rows are repeated G
    times for the stack, and autograd sums their gradient back per group."""
    from . import train_layer_kernel
    if cross_group > 1:
        mem_kv = mem_kv.repeat_interleave(cross_group, dim=1)
        mem_valid = mem_valid.repeat_interleave(cross_group, dim=0)
    return train_layer_kernel.decoder_stack_fused(
        stacked, x, mem_kv, self_valid, mem_valid, num_heads, dropout_rate,
        seeds, deterministic, plain=_PLAIN_TWINS or x.device.type == "cpu")
