"""One decode step through all decoder layers, as hand-written kernels.

Port of the JAX package's ``ops/pallas_monolith.py`` ``decode_layers``: one
decode token through all L post-norm decoder layers, with the fresh K/V
appended in place to the time-major ``(L, B, T, E)`` caches. Here each layer
is eleven launches of three kernels:

    qkv = LIN(x, Wqkv, bqkv)       a  = ATT(qkv, K_l, V_l, pos)   (self, appends)
    x   = K4(x, LIN(a, Wso, bso))
    qc  = LIN(x, Wcq, bcq)         c  = ATT(qc, MK_l, MV_l, bias) (cross)
    x   = K4(x, LIN(c, Wco, bco))
    x   = K4(x, LIN(LIN(x, W1, b1, gelu_rounded), W2, b2))

Compute-dtype caches: ATT = K2 ``decode_attention``
(``csrc/decode_attention.cu``). int8 caches (the monolith's quantized mode):
ATT = K6 ``decode_attention_int8`` (``csrc/decode_attention_int8.cu``), which
quantizes q/k/v per (row, head), appends the int8 rows and their scales, and
attends with integer products and quantized softmax weights. LIN = K1
``linear_bias_act`` for compute-dtype weights, K5 ``quant_linear_bias_act``
for int8 weights (W8A8) and K14 ``quant4_linear_bias_act`` for int4 weights
(W4A8). K1, K4, K5 and K14 live in their own modules. The final norm, the
unembedding and the argmax stay outside, as in the JAX decode loop. The
caches are updated in place (the JAX kernel aliases them in and out).

int8 scales are per (row, position, head) max-abs / 127, rounded to bf16
before quantizing, and stored as plain **bf16** tensors ``(L, B, T, H)``
(self) and ``(L, B/G, M, H)`` (memory): a bf16 tensor holds the rounded value
exactly and is half the bytes of fp32. The JAX package's lane-packed scale
planes are a TPU layout and are not reproduced.

``mem_group=G``: the memory holds ``B/G`` rows and batch row ``b`` attends to
memory row ``b // G`` (beams of one image share its memory).

The decode loops take this step while ``ACAI_MONOLITH_DECODE`` (read at
import, default on; :func:`set_enabled`) is on, and the per-op step of
:mod:`..models.decode` otherwise. The switch is the only gate: the JAX
package's lane and shape conditions of ``use_monolith`` are TPU limits.

Under int8 caches the weights follow two more switches, read at import as
the JAX package reads them: ``ACAI_W8A8_DECODE`` (default on;
:func:`set_w8a8`) and ``ACAI_W4A8_DECODE`` (default off; :func:`set_w4a8`),
resolved by :func:`weight_quant_mode`. With both off, int8 caches run K6
with compute-dtype weights (K1).
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import _build
from .layernorm_kernel import add_layernorm
from .linear_kernel import linear_bias_act
from .quant_linear_kernel import (INT4_QMAX, INT8_QMAX, pack_k4, pack_k8_int4,
                                  quant4_linear_bias_act,
                                  quant_linear_bias_act)

Params = dict

# K6 keeps one fp32 logit per key in shared memory (48 KB without opt-in)
MAX_INT8_KEYS = 8192
_MATS = ("w_qkv", "w_self_out", "w_cross_q", "w_cross_out", "w_ff1", "w_ff2")

_ENABLED = os.environ.get("ACAI_MONOLITH_DECODE", "1") == "1"
_W8A8 = os.environ.get("ACAI_W8A8_DECODE", "1") == "1"
_W4A8 = os.environ.get("ACAI_W4A8_DECODE", "0") == "1"


def set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = flag


def set_w8a8(flag: bool) -> None:
    global _W8A8
    _W8A8 = flag


def set_w4a8(flag: bool) -> None:
    global _W4A8
    _W4A8 = flag


def weight_quant_mode(cache_dtype):
    """The weights of the monolith step under ``cache_dtype``: ``"int4"``
    (W4A8, ``ACAI_W4A8_DECODE``), ``"int8"`` (W8A8, ``ACAI_W8A8_DECODE``) or
    False (compute dtype). Only int8 caches quantize the weights, and W4A8
    wins over W8A8, as the JAX package's single-device
    ``weight_quant_mode``."""
    if cache_dtype != torch.int8:
        return False
    if _W4A8:
        return "int4"
    return "int8" if _W8A8 else False


def use_monolith() -> bool:
    """Whether the decode loops take this module's step (time-major caches)
    rather than the per-op step (lane-major caches)."""
    return _ENABLED


def quantize_rows(x: torch.Tensor, scale_dtype=None):
    """(..., Dh) -> (int8 values, (...,) fp32 scale), max-abs per row.

    ``scale_dtype`` (bf16 for the decode caches) rounds the scale BEFORE
    quantizing, so the stored scale dequantizes exactly what was quantized.
    Division, not a product with a reciprocal, by 127 too: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal, so the divisor is
    a tensor on x's device. Round half to even."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, INT8_QMAX)
    if scale_dtype is not None:
        scale = scale.to(scale_dtype).float()
    q = torch.round(x32 / scale[..., None]).clamp(-INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def decode_attention_plain(q: torch.Tensor, k_layer: torch.Tensor,
                           v_layer: torch.Tensor, num_heads: int,
                           pos: int | None = None,
                           bias: torch.Tensor | None = None,
                           mem_group: int = 1) -> torch.Tensor:
    """Plain twin of K2.

    Self mode (``pos`` given): q is the (B, 3E) qkv row block; the fresh k/v
    are written into the (B, T, E) layer caches at ``pos`` and attention runs
    over positions [0, pos) plus the fresh token folded in analytically.
    Cross mode: q (B, E) attends over every row of memory row ``b //
    mem_group`` with the additive fp32 ``bias`` (B / mem_group, M). The
    unnormalised softmax weights are rounded to q's dtype before the PV
    product; the fresh token's term stays fp32.
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
        if mem_group > 1:
            keys, vals, bias = (a.repeat_interleave(mem_group, dim=0)
                                for a in (keys, vals, bias))
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


def _launch(op, q, k_layer, v_layer, num_heads, pos=None, bias=None,
            mem_group=1):
    _build.require(q, "q", torch.bfloat16, 2)
    _build.require(k_layer, "k_layer", torch.bfloat16, 3)
    _build.require(v_layer, "v_layer", torch.bfloat16, 3)
    bm, t, e = k_layer.shape
    b = q.shape[0]
    dh = e // num_heads
    if v_layer.shape != k_layer.shape or bm * mem_group != b \
            or dh * num_heads != e or dh not in (32, 64, 128):
        raise ValueError("decode_attention shape mismatch")
    fresh = pos is not None
    if fresh:
        if q.shape[1] != 3 * e or bias is not None or not 0 <= pos < t \
                or mem_group != 1:
            raise ValueError("self mode needs (B, 3E) qkv, 0 <= pos < T, "
                             "no bias, mem_group 1")
        k_new, v_new, n_keys, bias_ptr = (q.data_ptr() + 2 * e,
                                          q.data_ptr() + 4 * e, pos, 0)
    else:
        _build.require(bias, "bias", torch.float32, 2)
        if q.shape[1] != e or bias.shape != (bm, t):
            raise ValueError("cross mode needs (B, E) q and (B/G, M) bias")
        k_new = v_new = 0
        n_keys, bias_ptr = t, bias.data_ptr()
    out = torch.empty((b, e), dtype=torch.bfloat16, device=q.device)
    fn = _build.bind("decode_attention", "acai_decode_attention",
                     [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_float,
                                             ctypes.c_void_p,
                                             ctypes.c_void_p])
    rc = fn(q.data_ptr(), q.shape[1], k_new, v_new, k_layer.data_ptr(),
            v_layer.data_ptr(), b, num_heads, dh, t, n_keys, bias_ptr,
            -1 if pos is None else pos, mem_group, 1.0 / math.sqrt(dh),
            out.data_ptr(), _build.stream_ptr())
    op.launches += 1
    _build.check(rc, op.name)
    return out


decode_attention = _build.KernelOp(
    "decode_attention", "acai_omr_tpu_torch/csrc/decode_attention.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:825 (_attend_all, self and cross "
    "sites of _kernel :997) and :932 (_attend_shared, bf16 branch)",
    _launch, decode_attention_plain)


def decode_attention_int8_plain(q: torch.Tensor, k_layer: torch.Tensor,
                                v_layer: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, num_heads: int,
                                pos: int | None = None,
                                bias: torch.Tensor | None = None,
                                mem_group: int = 1) -> torch.Tensor:
    """Plain twin of K6: the monolith's quantized attention, term by term.

    k_layer/v_layer: (B, T, E) int8 with (B, T, H) bf16 scales. Self mode
    (``pos`` given): q is the (B, 3E) qkv block; q, k and v are quantized per
    head, the int8 k/v and their scales are written at ``pos``, and
    attention runs over positions [0, pos) plus the fresh token, whose logit
    and value come from the dequantized q, k and v in fp32. Cross mode: q
    (B, E) is quantized per head and attends over memory row
    ``b // mem_group`` with the additive ``bias`` (B / mem_group, M).

    Cached keys: logit = float(<qq, kq_t>) * ks_t * (qs / sqrt(dh)). The
    softmax weights are quantized, not rounded: w_v = exp(logit - m) * vs_t,
    ws = max(max_t w_v, 1e-30) / 127, out = float(<round(w_v / ws), vq>) * ws.
    The division by the denominator (unquantized weights) comes last. Both
    integer products are exact (the second one in float64).
    """
    b = q.shape[0]
    e = k_layer.shape[-1]
    h = num_heads
    dh = e // h
    scale = 1.0 / math.sqrt(dh)
    sd = k_scale.dtype
    heads = lambda a: a.float().reshape(b, h, dh)
    fresh = pos is not None
    if fresh:
        qq, qs = quantize_rows(heads(q[:, :e]), torch.bfloat16)
        kq, ks = quantize_rows(heads(q[:, e:2 * e]), torch.bfloat16)
        vq, vs = quantize_rows(heads(q[:, 2 * e:]), torch.bfloat16)
        k_layer[:, pos] = kq.reshape(b, e)
        v_layer[:, pos] = vq.reshape(b, e)
        k_scale[:, pos] = ks.to(sd)
        v_scale[:, pos] = vs.to(sd)
        keys, vals = k_layer[:, :pos], v_layer[:, :pos]
        kp, vp = k_scale[:, :pos], v_scale[:, :pos]
    else:
        qq, qs = quantize_rows(heads(q), torch.bfloat16)
        keys, vals, kp, vp = k_layer, v_layer, k_scale, v_scale
        if mem_group > 1:
            keys, vals, kp, vp, bias = (
                a.repeat_interleave(mem_group, dim=0)
                for a in (keys, vals, kp, vp, bias))
    n = keys.shape[1]
    qf = qq.float()
    dots = torch.einsum("bhd,bnhd->bhn", qf, keys.float().view(b, n, h, dh))
    logits = dots * kp.float().transpose(1, 2) * (qs * scale)[..., None]
    if bias is not None:
        logits = logits + bias.float()[:, None, :]
    m = logits.amax(dim=-1) if n else None
    if fresh:
        kd, vd = kq.float() * ks[..., None], vq.float() * vs[..., None]
        lc = ((qf * qs[..., None]) * kd).sum(-1) * scale
        m = lc if m is None else torch.maximum(m, lc)
    w = torch.exp(logits - m[..., None])
    denom = w.sum(dim=-1)
    w_v = w * vp.float().transpose(1, 2)
    ws = (w_v.amax(dim=-1) if n else torch.zeros_like(denom)) \
        .clamp_min(1e-30) / INT8_QMAX
    wq = torch.round(w_v / ws[..., None])
    out = torch.einsum("bhn,bnhd->bhd", wq.double(),
                       vals.double().view(b, n, h, dh)).float() * ws[..., None]
    if fresh:
        wc = torch.exp(lc - m)
        denom = denom + wc
        out = out + wc[..., None] * vd
    return (out / denom[..., None]).reshape(b, e).to(q.dtype)


def _launch_int8(op, q, k_layer, v_layer, k_scale, v_scale, num_heads,
                 pos=None, bias=None, mem_group=1):
    _build.require(q, "q", torch.bfloat16, 2)
    _build.require(k_layer, "k_layer", torch.int8, 3)
    _build.require(v_layer, "v_layer", torch.int8, 3)
    _build.require(k_scale, "k_scale", torch.bfloat16, 3)
    _build.require(v_scale, "v_scale", torch.bfloat16, 3)
    bm, t, e = k_layer.shape
    b = q.shape[0]
    dh = e // num_heads
    if v_layer.shape != k_layer.shape or bm * mem_group != b \
            or dh * num_heads != e or dh not in (32, 64, 128) \
            or k_scale.shape != (bm, t, num_heads) \
            or v_scale.shape != k_scale.shape or t > MAX_INT8_KEYS:
        raise ValueError("decode_attention_int8 shape mismatch")
    fresh = pos is not None
    if fresh:
        if q.shape[1] != 3 * e or bias is not None or not 0 <= pos < t \
                or mem_group != 1:
            raise ValueError("self mode needs (B, 3E) qkv, 0 <= pos < T, "
                             "no bias, mem_group 1")
        n_keys, bias_ptr = pos, 0
    else:
        _build.require(bias, "bias", torch.float32, 2)
        if q.shape[1] != e or bias.shape != (bm, t):
            raise ValueError("cross mode needs (B, E) q and (B/G, M) bias")
        n_keys, bias_ptr = t, bias.data_ptr()
    out = torch.empty((b, e), dtype=torch.bfloat16, device=q.device)
    fn = _build.bind("decode_attention_int8", "acai_decode_attention_int8",
                     [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_float,
                                             ctypes.c_void_p,
                                             ctypes.c_void_p])
    rc = fn(q.data_ptr(), q.shape[1], k_layer.data_ptr(), v_layer.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), b, num_heads, dh, t,
            n_keys, bias_ptr, -1 if pos is None else pos, mem_group,
            1.0 / math.sqrt(dh), out.data_ptr(), _build.stream_ptr())
    op.launches += 1
    _build.check(rc, op.name)
    return out


decode_attention_int8 = _build.KernelOp(
    "decode_attention_int8",
    "acai_omr_tpu_torch/csrc/decode_attention_int8.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:725 (_quant_rows), :859-917 "
    "(_attend_all int8), :951-986 (_attend_shared int8), :1382-1423 "
    "(quantized append)",
    _launch_int8, decode_attention_int8_plain)


def prepack(params: Params, compute_dtype=torch.bfloat16,
            quantize_weights=False) -> Params:
    """Decoder params -> the step's operands (the JAX
    ``pallas_monolith.prepack``): weight matrices in the compute dtype; every
    bias and LayerNorm vector rounded to the compute dtype (as the JAX
    ``misc`` plane) and held in fp32 for the kernels' epilogues.

    ``quantize_weights=True`` or ``"int8"`` (the int8 decode mode, W8A8):
    every weight matrix int8 with one max-abs scale per output column over
    the full input, rounded to bf16 before quantizing; the matrices are held
    K-packed (:func:`..quant_linear_kernel.pack_k4`) under their usual names,
    the fp32 column scales under ``s_<name>``.

    ``quantize_weights="int4"`` (W4A8): the same with max-abs / 7 scales and
    values clipped to [-7, 7], held as (L, IN/8, OUT) int32 words
    (:func:`..quant_linear_kernel.pack_k8_int4`); the int32 dtype is what
    tells :func:`decode_layers` to take K14."""
    if quantize_weights not in (False, True, "int8", "int4"):
        raise ValueError(f"unsupported weight mode {quantize_weights!r}")
    qmax, pack = (INT4_QMAX, pack_k8_int4) if quantize_weights == "int4" \
        else (INT8_QMAX, pack_k4)
    blocks = params["blocks"]
    e = blocks["self_attn"]["out"]["kernel"].shape[-1]
    sa, ca = blocks["self_attn"], blocks["cross_attn"]
    vec = lambda a: a.to(compute_dtype).float().contiguous()
    mats = dict(zip(_MATS, (
        sa["in_kernel"], sa["out"]["kernel"], ca["in_kernel"][:, :, :e],
        ca["out"]["kernel"], blocks["linear1"]["kernel"],
        blocks["linear2"]["kernel"])))
    out = {}
    for name, w in mats.items():
        if not quantize_weights:
            out[name] = w.to(compute_dtype).contiguous()
            continue
        w32 = w.float()                                      # (L, IN, OUT)
        s = (w32.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / qmax) \
            .to(torch.bfloat16).float()
        out[name] = pack(torch.round(w32 / s).clamp(-qmax, qmax)
                         .to(torch.int8))
        out["s_" + name[2:]] = s[:, 0].contiguous()
    out.update({
        "b_qkv": vec(sa["in_bias"]), "b_self_out": vec(sa["out"]["bias"]),
        "b_cross_q": vec(ca["in_bias"][:, :e]),
        "b_cross_out": vec(ca["out"]["bias"]),
        "b_ff1": vec(blocks["linear1"]["bias"]),
        "b_ff2": vec(blocks["linear2"]["bias"]),
        **{f"ln{i}_{s}": vec(blocks[f"norm{i}"][k])
           for i in (1, 2, 3) for s, k in (("g", "scale"), ("b", "bias"))},
    })
    return out


def decode_layers(mono: Params, x: torch.Tensor, pos: int,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  mem_k: torch.Tensor, mem_v: torch.Tensor,
                  mem_bias: torch.Tensor, num_heads: int,
                  plain: bool = False, k_scale: torch.Tensor | None = None,
                  v_scale: torch.Tensor | None = None,
                  mem_k_scale: torch.Tensor | None = None,
                  mem_v_scale: torch.Tensor | None = None,
                  mem_group: int = 1) -> torch.Tensor:
    """One token through every decoder layer.

    x: (B, E) embedded token in the compute dtype; k_cache/v_cache:
    (L, B, T, E), appended in place at ``pos``; mem_k/mem_v: (L, B/G, M, E);
    mem_bias: (B/G, M) fp32 additive padding bias. With int8 caches pass the
    bf16 scales k_scale/v_scale (L, B, T, H), appended in place too, and
    mem_k_scale/mem_v_scale (L, B/G, M, H). ``mono`` from :func:`prepack`
    decides the products: int8 weights run W8A8 (K5), int4 weights W4A8
    (K14); both need int8 caches, as in the JAX package. Returns (B, E).

    On CUDA tensors every op is a kernel launch (K1, K5 or K14, K2 or K6,
    K4); on CPU tensors the plain twins run. ``plain=True`` runs the plain
    twins on any device.
    """
    quantized = k_scale is not None
    w_quant = "s_qkv" in mono
    if w_quant and not quantized:
        raise ValueError("W8A8 / W4A8 weights need int8 caches")
    b, e = x.shape
    if mem_k.shape[1] * mem_group != b:
        raise ValueError(f"mem rows {mem_k.shape[1]} x group {mem_group} "
                         f"!= batch {b}")
    if quantized:
        dh = e // num_heads
        if dh * num_heads != e or dh & (dh - 1):
            raise ValueError(f"int8 caches need a power-of-two head dim, got "
                             f"E={e}, heads={num_heads}")
        if max(k_cache.shape[2], mem_k.shape[2]) > MAX_INT8_KEYS:
            raise ValueError(
                f"int8 attention holds at most {MAX_INT8_KEYS} keys in shared "
                f"memory, got T={k_cache.shape[2]}, M={mem_k.shape[2]}")
    lin = linear_bias_act
    if w_quant:
        lin = quant4_linear_bias_act if mono["w_qkv"].dtype == torch.int32 \
            else quant_linear_bias_act
    attn = decode_attention_int8 if quantized else decode_attention
    ln = add_layernorm
    if plain:
        lin, attn, ln = lin.plain, attn.plain, ln.plain
    p = mono

    def mat(xv, i, name, act="none"):
        w = (p["w_" + name][i],)
        if w_quant:
            w += (p["s_" + name][i],)
        return lin(xv, *w, p["b_" + name][i], act)

    for i in range(k_cache.shape[0]):
        self_kv = (k_cache[i], v_cache[i])
        mem_kv = (mem_k[i], mem_v[i])
        if quantized:
            self_kv += (k_scale[i], v_scale[i])
            mem_kv += (mem_k_scale[i], mem_v_scale[i])
        a = attn(mat(x, i, "qkv"), *self_kv, num_heads, pos=pos)
        x = ln(x, mat(a, i, "self_out"), p["ln1_g"][i], p["ln1_b"][i], 1e-5)
        c = attn(mat(x, i, "cross_q"), *mem_kv, num_heads, bias=mem_bias,
                 mem_group=mem_group)
        x = ln(x, mat(c, i, "cross_out"), p["ln2_g"][i], p["ln2_b"][i], 1e-5)
        f = mat(x, i, "ff1", "gelu_rounded")
        x = ln(x, mat(f, i, "ff2"), p["ln3_g"][i], p["ln3_b"][i], 1e-5)
    return x
