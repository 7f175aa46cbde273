"""The ViT encoder stack forward as a family of hand-written kernels.

Port of the JAX package's ``ops/pallas_train_layer.py`` forward
(``encoder_stack_fused`` -> ``_fwd_call`` -> ``_fwd_kernel`` with
``cross=False`` and no saves), which runs the whole post-norm encoder stack in
one Pallas grid. Here each layer is seven launches of three kernels:

    qkv = K1(x, Wqkv, bqkv)            attn = K3(qkv, valid)
    x1  = K4(x, K1(attn, Wo, bo))      h    = K1(x1, W1, b1, gelu)
    x   = K4(x1, K1(h, W2, b2))

K3 ``encoder_attention`` lives in this module (CUDA source
``csrc/encoder_attention.cu``); K1 and K4 are shared with the decode step.
Numerics follow ``_fwd_kernel``: qkv and every projection rounded to the
compute dtype after its fp32 bias add, softmax probabilities normalised in
fp32 before the bf16 PV product, exact GELU on the fp32 ff1 sum, residual
sums in the compute dtype before each fp32 LayerNorm (eps 1e-5).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

Params = dict


def attention_bias(valid: torch.Tensor, tq: int, causal: bool) -> torch.Tensor:
    """(B, 1, Tq or 1, Tk) fp32 additive mask: -1e9 for a padded key, plus
    -1e9 for a key after the query when ``causal`` (additive, not -inf: a row
    with no valid key attends uniformly, as in the JAX kernels)."""
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    neg = torch.full((), -1e9, dtype=torch.float32, device=valid.device)
    bias = torch.where(valid, zero, neg)[:, None, None, :]
    if causal:
        tk = valid.shape[1]
        allowed = torch.tril(torch.ones((tq, tk), dtype=torch.bool,
                                        device=valid.device))
        bias = torch.where(allowed, zero, neg)[None, None] + bias
    return bias


def split_qkv(qkv: torch.Tensor, kv: torch.Tensor | None, b: int):
    """(q, k, v) as (B, T, E) views (last stride 1): of one (B*T, 3E) qkv
    buffer, or of qc (B*Tq, E) and a layer's mem_kv (B, M, 2E)."""
    if kv is None:
        e = qkv.shape[1] // 3
        return qkv.view(b, -1, 3 * e).split(e, dim=-1)
    e = qkv.shape[1]
    return (qkv.view(b, -1, e), *kv.split(e, dim=-1))


def attention_probs(q, k, v, valid, num_heads: int, causal: bool):
    """fp32 probabilities (B, H, Tq, Tk), normalised before any rounding, and
    the per-head views of q, k, v (B, H, T, Dh)."""
    b, tq, e = q.shape
    dh = e // num_heads
    heads = lambda a: a.reshape(b, a.shape[1], num_heads, dh).transpose(1, 2)
    qh, kh, vh = heads(q), heads(k), heads(v)
    lg = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(dh)) + attention_bias(valid, tq, causal)
    ex = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    return ex / ex.sum(dim=-1, keepdim=True), qh, kh, vh


def encoder_attention_plain(qkv: torch.Tensor, valid: torch.Tensor,
                            num_heads: int, causal: bool = False,
                            kv: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of K3. Self-attention: (B*T, 3E) qkv, (B, T) bool validity
    -> (B*T, E). Cross-attention (``kv`` given): qkv is qc (B*Tq, E), kv is
    (B, M, 2E), valid is (B, M)."""
    b = valid.shape[0]
    q, k, v = split_qkv(qkv, kv, b)
    p, _, _, vh = attention_probs(q, k, v, valid, num_heads, causal)
    out = torch.matmul(p.to(qkv.dtype).float(), vh.float())
    return out.transpose(1, 2).reshape(q.shape[0] * q.shape[1],
                                       q.shape[2]).to(qkv.dtype)


def check_attention_operands(name: str, q, k, v, valid, num_heads: int):
    """Shapes and strides K3 and K7 take; returns (B, Tq, Tk, E, Dh)."""
    b, tq, e = q.shape
    tk = k.shape[1]
    dh = e // num_heads
    if k.shape != (b, tk, e) or v.shape != k.shape or dh * num_heads != e \
            or valid.shape != (b, tk):
        raise ValueError(f"{name} shape mismatch")
    if dh not in (32, 64) or tq % 64 or tk % 64:
        raise ValueError(
            f"{name} needs Dh == 64 (the ViT encoder, the seq2seq decoder) "
            f"or Dh == 32 (the MAE decoder) and query and key lengths that "
            f"are multiples of 64 (the training packers pad T and M to "
            f"multiples of 128), got Dh={dh}, Tq={tq}, Tk={tk}")
    for a in (q, k, v):
        if not a.is_cuda or a.dtype != torch.bfloat16:
            raise ValueError(f"{name} takes CUDA bf16 tensors")
        if a.stride(2) != 1 or a.stride(0) != a.shape[1] * a.stride(1) \
                or a.stride(1) % 8:
            raise ValueError(f"{name} takes row-strided views only")
    if k.stride(1) != v.stride(1):
        raise ValueError(f"{name}: k and v must share a row stride")
    if valid.device != q.device:
        raise ValueError(f"{name}: operands must be on one device")
    return b, tq, tk, e, dh


def _launch(op, qkv, valid, num_heads, causal=False, kv=None):
    _build.require(qkv, "qkv", torch.bfloat16, 2)
    if kv is not None:
        _build.require(kv, "kv", torch.bfloat16, 3)
    q, k, v = split_qkv(qkv, kv, valid.shape[0])
    b, tq, tk, e, dh = check_attention_operands(op.name, q, k, v, valid,
                                                num_heads)
    valid_u8 = valid.to(torch.uint8).contiguous()
    out = torch.empty((b * tq, e), dtype=torch.bfloat16, device=qkv.device)
    fn = _build.bind("encoder_attention", "acai_encoder_attention",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_u8.data_ptr(),
            out.data_ptr(), b, tq, tk, num_heads, dh, q.stride(1),
            k.stride(1), 1.0 / math.sqrt(dh), int(causal),
            _build.stream_ptr())
    op.launched(f"dh{dh}")
    _build.check(rc, op.name)
    return out


encoder_attention = _build.KernelOp(
    "encoder_attention", "acai_omr_tpu_torch/csrc/encoder_attention.cu",
    "acai_omr_tpu/ops/pallas_train_layer.py:438 (_fwd_kernel _attend loops "
    ":482-509 self, :521-533 cross)",
    _launch, encoder_attention_plain)


def encoder_stack_fused(stacked: Params, x: torch.Tensor, valid: torch.Tensor,
                        num_heads: int, plain: bool = False) -> torch.Tensor:
    """The encoder stack forward at inference: x (B, T, E), valid (B, T) bool
    -> (B, T, E), no dropout.

    On CUDA tensors every product, attention and LayerNorm is a launch of
    K1/K3/K4; on CPU tensors each op runs its plain twin. ``plain=True`` runs
    the plain twins on any device (the on-card yardstick of the kernel path).
    The training stack with saves, dropout and the hand-written backward is
    :func:`.train_layer_kernel.encoder_stack_fused`, which this calls.
    """
    from . import train_layer_kernel
    return train_layer_kernel.encoder_stack_fused(stacked, x, valid,
                                                  num_heads, plain=plain)
