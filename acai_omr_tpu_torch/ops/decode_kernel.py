"""One greedy decode step through all decoder layers, as hand-written kernels.

Port of the JAX package's ``ops/pallas_monolith.py`` ``decode_layers`` in
bf16 mode: one decode token through all L post-norm decoder layers, with the
fresh K/V appended in place to the time-major ``(L, B, T, E)`` caches. Here
each layer is eleven launches of three kernels:

    qkv = K1(x, Wqkv, bqkv)        a  = K2(qkv, K_l, V_l, pos)   (self, appends)
    x   = K4(x, K1(a, Wso, bso))
    qc  = K1(x, Wcq, bcq)          c  = K2(qc, MK_l, MV_l, bias) (cross)
    x   = K4(x, K1(c, Wco, bco))
    x   = K4(x, K1(K1(x, W1, b1, gelu_rounded), W2, b2))

K2 ``decode_attention`` lives in this module (CUDA source
``csrc/decode_attention.cu``); K1 and K4 are shared with the encoder stack.
The final norm, the unembedding and the argmax stay outside, as in the JAX
decode loop. The caches are updated in place (the JAX kernel aliases them
in and out).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .layernorm_kernel import add_layernorm
from .linear_kernel import linear_bias_act

Params = dict


def decode_attention_plain(q: torch.Tensor, k_layer: torch.Tensor,
                           v_layer: torch.Tensor, num_heads: int,
                           pos: int | None = None,
                           bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of K2.

    Self mode (``pos`` given): q is the (B, 3E) qkv row block; the fresh k/v
    are written into the (B, T, E) layer caches at ``pos`` and attention runs
    over positions [0, pos) plus the fresh token folded in analytically.
    Cross mode: q (B, E) attends over every memory row with the additive
    fp32 ``bias`` (B, M). The unnormalised softmax weights are rounded to q's
    dtype before the PV product; the fresh token's term stays fp32.
    """
    b = q.shape[0]
    e = k_layer.shape[-1]
    dh = e // num_heads
    scale = 1.0 / math.sqrt(dh)
    fresh = pos is not None
    if fresh:
        qh, kn, vn = q[:, :e], q[:, e:2 * e], q[:, 2 * e:]
        k_layer[:, pos] = kn
        v_layer[:, pos] = vn
        keys, vals = k_layer[:, :pos], v_layer[:, :pos]
    else:
        qh, keys, vals = q, k_layer, v_layer
    n = keys.shape[1]
    qf = qh.float().view(b, num_heads, dh)
    logits = torch.einsum("bhd,bnhd->bhn", qf,
                          keys.float().view(b, n, num_heads, dh)) * scale
    if bias is not None:
        logits = logits + bias.float()[:, None, :]
    m = logits.amax(dim=-1) if n else None
    if fresh:
        lc = (qf * kn.float().view(b, num_heads, dh)).sum(-1) * scale
        m = lc if m is None else torch.maximum(m, lc)
    w = torch.exp(logits - m[..., None])
    denom = w.sum(dim=-1)
    out = torch.einsum("bhn,bnhd->bhd", w.to(q.dtype).float(),
                       vals.float().view(b, n, num_heads, dh))
    if fresh:
        wc = torch.exp(lc - m)
        denom = denom + wc
        out = out + wc[..., None] * vn.float().view(b, num_heads, dh)
    return (out / denom[..., None]).reshape(b, e).to(q.dtype)


def _launch(op, q, k_layer, v_layer, num_heads, pos=None, bias=None):
    _build.require(q, "q", torch.bfloat16, 2)
    _build.require(k_layer, "k_layer", torch.bfloat16, 3)
    _build.require(v_layer, "v_layer", torch.bfloat16, 3)
    b, t, e = k_layer.shape
    dh = e // num_heads
    if v_layer.shape != k_layer.shape or q.shape[0] != b \
            or dh * num_heads != e or dh not in (32, 64, 128):
        raise ValueError("decode_attention shape mismatch")
    fresh = pos is not None
    if fresh:
        if q.shape[1] != 3 * e or bias is not None or not 0 <= pos < t:
            raise ValueError("self mode needs (B, 3E) qkv, 0 <= pos < T, "
                             "no bias")
        k_new, v_new, n_keys, bias_ptr = (q.data_ptr() + 2 * e,
                                          q.data_ptr() + 4 * e, pos, 0)
    else:
        _build.require(bias, "bias", torch.float32, 2)
        if q.shape[1] != e or bias.shape != (b, t):
            raise ValueError("cross mode needs (B, E) q and (B, M) bias")
        k_new = v_new = 0
        n_keys, bias_ptr = t, bias.data_ptr()
    out = torch.empty((b, e), dtype=torch.bfloat16, device=q.device)
    fn = _build.bind("decode_attention", "acai_decode_attention",
                     [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_float, ctypes.c_void_p,
                                             ctypes.c_void_p])
    rc = fn(q.data_ptr(), q.shape[1], k_new, v_new, k_layer.data_ptr(),
            v_layer.data_ptr(), b, num_heads, dh, t, n_keys, bias_ptr,
            -1 if pos is None else pos, 1.0 / math.sqrt(dh), out.data_ptr(),
            _build.stream_ptr())
    op.launches += 1
    _build.check(rc, op.name)
    return out


decode_attention = _build.KernelOp(
    "decode_attention", "acai_omr_tpu_torch/csrc/decode_attention.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:825 (_attend_all, self and cross "
    "sites of _kernel :997)",
    _launch, decode_attention_plain)


def prepack(params: Params, compute_dtype=torch.bfloat16) -> Params:
    """Decoder params -> the step's operands (the bf16 branch of the JAX
    ``pallas_monolith.prepack``): weight matrices in the compute dtype; every
    bias and LayerNorm vector rounded to the compute dtype (as the JAX
    ``misc`` plane) and held in fp32 for the kernels' epilogues."""
    blocks = params["blocks"]
    e = blocks["self_attn"]["out"]["kernel"].shape[-1]
    sa, ca = blocks["self_attn"], blocks["cross_attn"]
    w = lambda a: a.to(compute_dtype).contiguous()
    vec = lambda a: a.to(compute_dtype).float().contiguous()
    return {
        "w_qkv": w(sa["in_kernel"]), "b_qkv": vec(sa["in_bias"]),
        "w_self_out": w(sa["out"]["kernel"]),
        "b_self_out": vec(sa["out"]["bias"]),
        "w_cross_q": w(ca["in_kernel"][:, :, :e]),
        "b_cross_q": vec(ca["in_bias"][:, :e]),
        "w_cross_out": w(ca["out"]["kernel"]),
        "b_cross_out": vec(ca["out"]["bias"]),
        "w_ff1": w(blocks["linear1"]["kernel"]),
        "b_ff1": vec(blocks["linear1"]["bias"]),
        "w_ff2": w(blocks["linear2"]["kernel"]),
        "b_ff2": vec(blocks["linear2"]["bias"]),
        **{f"ln{i}_{s}": vec(blocks[f"norm{i}"][k])
           for i in (1, 2, 3) for s, k in (("g", "scale"), ("b", "bias"))},
    }


def decode_layers(mono: Params, x: torch.Tensor, pos: int,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  mem_k: torch.Tensor, mem_v: torch.Tensor,
                  mem_bias: torch.Tensor, num_heads: int,
                  plain: bool = False) -> torch.Tensor:
    """One token through every decoder layer.

    x: (B, E) embedded token in the compute dtype; k_cache/v_cache:
    (L, B, T, E), appended in place at ``pos``; mem_k/mem_v: (L, B, M, E);
    mem_bias: (B, M) fp32 additive padding bias. Returns (B, E).

    On CUDA tensors every op is a launch of K1/K2/K4; on CPU tensors the
    plain twins run. ``plain=True`` runs the plain twins on any device.
    """
    lin, attn, ln = linear_bias_act, decode_attention, add_layernorm
    if plain:
        lin, attn, ln = lin.plain, attn.plain, ln.plain
    p = mono
    for i in range(k_cache.shape[0]):
        qkv = lin(x, p["w_qkv"][i], p["b_qkv"][i])
        a = attn(qkv, k_cache[i], v_cache[i], num_heads, pos=pos)
        x = ln(x, lin(a, p["w_self_out"][i], p["b_self_out"][i]),
               p["ln1_g"][i], p["ln1_b"][i], 1e-5)
        qc = lin(x, p["w_cross_q"][i], p["b_cross_q"][i])
        c = attn(qc, mem_k[i], mem_v[i], num_heads, bias=mem_bias)
        x = ln(x, lin(c, p["w_cross_out"][i], p["b_cross_out"][i]),
               p["ln2_g"][i], p["ln2_b"][i], 1e-5)
        f = lin(x, p["w_ff1"][i], p["b_ff1"][i], "gelu_rounded")
        x = ln(x, lin(f, p["w_ff2"][i], p["b_ff2"][i]),
               p["ln3_g"][i], p["ln3_b"][i], 1e-5)
    return x
