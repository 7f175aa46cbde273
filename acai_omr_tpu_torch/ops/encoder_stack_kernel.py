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
from .layernorm_kernel import add_layernorm
from .linear_kernel import linear_bias_act

Params = dict


def encoder_attention_plain(qkv: torch.Tensor, valid: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Plain twin of K3: (B*T, 3E) qkv, (B, T) bool validity -> (B*T, E)."""
    b, t = valid.shape
    e = qkv.shape[1] // 3
    dh = e // num_heads
    q, k, v = qkv.view(b, t, 3, num_heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    zero = torch.zeros((), dtype=torch.float32, device=qkv.device)
    neg = torch.full((), -1e9, dtype=torch.float32, device=qkv.device)
    bias = torch.where(valid, zero, neg)[:, None, None, :]
    lg = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(dh)) + bias
    ex = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    p = ex / ex.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(qkv.dtype).float(), v.float())
    return out.permute(0, 2, 1, 3).reshape(b * t, e).to(qkv.dtype)


def _launch(op, qkv, valid, num_heads):
    _build.require(qkv, "qkv", torch.bfloat16, 2)
    b, t = valid.shape
    e = qkv.shape[1] // 3
    dh = e // num_heads
    if qkv.shape[0] != b * t or dh * num_heads != e:
        raise ValueError("encoder_attention shape mismatch")
    if dh != 64 or t % 64:
        raise ValueError(f"encoder_attention needs Dh == 64 and T % 64 == 0, "
                         f"got Dh={dh}, T={t}")
    if valid.device != qkv.device:
        raise ValueError("qkv and valid must be on one device")
    valid_u8 = valid.to(torch.uint8).contiguous()
    out = torch.empty((b * t, e), dtype=torch.bfloat16, device=qkv.device)
    fn = _build.bind("encoder_attention", "acai_encoder_attention",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                     + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(qkv.data_ptr(), valid_u8.data_ptr(), out.data_ptr(), b, t,
            num_heads, dh, 1.0 / math.sqrt(dh), _build.stream_ptr())
    op.launches += 1
    _build.check(rc, op.name)
    return out


encoder_attention = _build.KernelOp(
    "encoder_attention", "acai_omr_tpu_torch/csrc/encoder_attention.cu",
    "acai_omr_tpu/ops/pallas_train_layer.py:438 (_fwd_kernel _attend loop "
    ":482-509)",
    _launch, encoder_attention_plain)


def pack_weights_enc(stacked: Params, dtype) -> Params:
    """Stacked encoder-layer params -> the kernels' operands: weights in the
    compute dtype, biases and LayerNorm vectors in fp32 (as the JAX kernel's
    fp32 ``vecs`` plane)."""
    sa = stacked["self_attn"]
    w = lambda a: a.to(dtype).contiguous()
    f32 = lambda a: a.float().contiguous()
    return {
        "w_qkv": w(sa["in_kernel"]), "b_qkv": f32(sa["in_bias"]),
        "w_out": w(sa["out"]["kernel"]), "b_out": f32(sa["out"]["bias"]),
        "w_ff1": w(stacked["linear1"]["kernel"]),
        "b_ff1": f32(stacked["linear1"]["bias"]),
        "w_ff2": w(stacked["linear2"]["kernel"]),
        "b_ff2": f32(stacked["linear2"]["bias"]),
        "ln1_g": f32(stacked["norm1"]["scale"]),
        "ln1_b": f32(stacked["norm1"]["bias"]),
        "ln2_g": f32(stacked["norm2"]["scale"]),
        "ln2_b": f32(stacked["norm2"]["bias"]),
    }


def encoder_stack_fused(stacked: Params, x: torch.Tensor, valid: torch.Tensor,
                        num_heads: int, plain: bool = False) -> torch.Tensor:
    """The encoder stack forward: x (B, T, E), valid (B, T) bool -> (B, T, E).

    On CUDA tensors every product, attention and LayerNorm is a launch of
    K1/K3/K4; on CPU tensors each op runs its plain twin. ``plain=True`` runs
    the plain twins on any device (the on-card yardstick of the kernel path).
    """
    lin, attn, ln = linear_bias_act, encoder_attention, add_layernorm
    if plain:
        lin, attn, ln = lin.plain, attn.plain, ln.plain
    p = pack_weights_enc(stacked, x.dtype)
    b, t, e = x.shape
    h = x.reshape(b * t, e).contiguous()
    for i in range(p["w_qkv"].shape[0]):
        qkv = lin(h, p["w_qkv"][i], p["b_qkv"][i])
        a = attn(qkv, valid, num_heads)
        h = ln(h, lin(a, p["w_out"][i], p["b_out"][i]), p["ln1_g"][i],
               p["ln1_b"][i], 1e-5)
        f = lin(h, p["w_ff1"][i], p["b_ff1"][i], "gelu")
        h = ln(h, lin(f, p["w_ff2"][i], p["b_ff2"][i]), p["ln2_g"][i],
               p["ln2_b"][i], 1e-5)
    return h.reshape(b, t, e)
