"""Single-query attention of the per-op decode step, as hand-written kernels.

Port of the JAX package's ``ops/pallas_decode.py``: the attention kernels of
the per-op ("lane-major") decode step, which keeps its caches as
``(L, B, H, Dh, T)`` planes with the time axis last. Three kernels:

* K11 :data:`decode_attention_hd` (``csrc/decode_attention_hd.cu``): q
  ``(B, H, Dh)`` against kT / vT ``(B, H, Dh, T)`` in the compute dtype, fp32
  softmax, the division after the V sum.
* K12 :data:`decode_attention_hd_int8` (``csrc/decode_attention_hd_int8.cu``):
  the same over int8 planes with fp32 ``(B, H, T)`` scales, per layer or
  reading layer ``layer`` of a stacked ``(L, B, H, Dh, T)`` cache.
* K13 :data:`self_attention_append_int8`
  (``csrc/self_attention_append_int8.cu``): quantizes the fresh k / v rows,
  writes them and their scales into column ``pos`` of layer ``layer`` in
  place, and attends over the positions before ``pos`` plus the fresh token.

The switches mirror the JAX package's and are the only gates:
``ACAI_PALLAS_DECODE`` (K11, default off) and ``ACAI_PALLAS_DECODE_INT8``
(K12 / K13, default on), read at import, changed with :func:`set_enabled` /
:func:`set_enabled_int8`. The TPU shape and VMEM conditions of the JAX
``use_pallas`` are not carried over: the kernels take every shape.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import _build
from .decode_kernel import quantize_rows

_ENABLED = os.environ.get("ACAI_PALLAS_DECODE", "0") == "1"
_ENABLED_INT8 = os.environ.get("ACAI_PALLAS_DECODE_INT8", "1") == "1"

# logits (and the query) live in shared memory: 227 KB a block at most
MAX_KEYS = 227 * 1024 // 4 - 3 * 128


def set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = flag


def set_enabled_int8(flag: bool) -> None:
    global _ENABLED_INT8
    _ENABLED_INT8 = flag


def use_kernel(cache_dtype) -> bool:
    """Whether the per-op step attends through these kernels for caches of
    ``cache_dtype`` (the switch of that dtype)."""
    return _ENABLED_INT8 if cache_dtype == torch.int8 else _ENABLED


def _keys(t: int, n_keys) -> int:
    n = t if n_keys is None else n_keys
    if not 1 <= n <= t:
        raise ValueError(f"n_keys={n} outside [1, {t}]")
    return n


def _check_keys(n: int, dh: int) -> None:
    if n + 3 * dh > MAX_KEYS:
        raise ValueError(f"{n} keys do not fit the kernel's shared memory")


def decode_attention_hd_plain(q: torch.Tensor, kT: torch.Tensor,
                              vT: torch.Tensor,
                              bias: torch.Tensor | None = None,
                              n_keys: int | None = None) -> torch.Tensor:
    """Plain twin of K11: q (B, H, Dh), kT/vT (B, H, Dh, T), bias (B, T) fp32
    or None -> (B, H, Dh) in q's dtype. q, k, v in fp32; unnormalised
    ``exp(logits - max)``; the V sum divided by the weights' sum after.
    Only the first ``n_keys`` positions are read."""
    n = _keys(kT.shape[-1], n_keys)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhd,bhdt->bht", q.float(),
                          kT[..., :n].float()) * scale
    if bias is not None:
        logits = logits + bias[:, None, :n].float()
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("bht,bhdt->bhd", w, vT[..., :n].float())
    return (out / w.sum(dim=-1)[..., None]).to(q.dtype)


def _launch_hd(op, q, kT, vT, bias=None, n_keys=None):
    _build.require(q, "q", torch.bfloat16, 3)
    _build.require(kT, "kT", torch.bfloat16, 4)
    _build.require(vT, "vT", torch.bfloat16, 4)
    b, h, dh = q.shape
    t = kT.shape[-1]
    if kT.shape != (b, h, dh, t) or vT.shape != kT.shape:
        raise ValueError("decode_attention_hd shape mismatch")
    if bias is not None:
        _build.require(bias, "bias", torch.float32, 2)
        if bias.shape != (b, t):
            raise ValueError("bias must be (B, T)")
    n = _keys(t, n_keys)
    _check_keys(n, dh)
    out = torch.empty_like(q)
    fn = _build.bind("decode_attention_hd", "acai_decode_attention_hd",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                     + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    rc = fn(q.data_ptr(), kT.data_ptr(), vT.data_ptr(),
            0 if bias is None else bias.data_ptr(), b, h, dh, t, n,
            1.0 / math.sqrt(dh), out.data_ptr(), _build.stream_ptr())
    op.launches += 1
    _build.check(rc, op.name)
    return out


decode_attention_hd = _build.KernelOp(
    "decode_attention_hd", "acai_omr_tpu_torch/csrc/decode_attention_hd.cu",
    "acai_omr_tpu/ops/pallas_decode.py:77 (_kernel, pallas_call :382)",
    _launch_hd, decode_attention_hd_plain)


def decode_attention_hd_int8_plain(q: torch.Tensor, kT: torch.Tensor,
                                   vT: torch.Tensor, k_scale: torch.Tensor,
                                   v_scale: torch.Tensor,
                                   bias: torch.Tensor | None = None,
                                   layer: int | None = None,
                                   n_keys: int | None = None) -> torch.Tensor:
    """Plain twin of K12: q (B, H, Dh) against int8 kT/vT (B, H, Dh, T) with
    fp32 scales (B, H, T), or layer ``layer`` of stacked (L, B, H, Dh, T) /
    (L, B, H, T) arrays. ``(<q, k> * scale) * ks + bias``, a normalised fp32
    softmax, then ``* vs``, then the V sum; nothing rounded before the
    output."""
    if layer is not None:
        kT, vT, k_scale, v_scale = (a[layer] for a in (kT, vT, k_scale,
                                                       v_scale))
    n = _keys(kT.shape[-1], n_keys)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhd,bhdt->bht", q.float(),
                          kT[..., :n].float()) * scale
    logits = logits * k_scale[..., :n]
    if bias is not None:
        logits = logits + bias[:, None, :n].float()
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True) * v_scale[..., :n]
    return torch.einsum("bht,bhdt->bhd", w, vT[..., :n].float()).to(q.dtype)


def _launch_hd_int8(op, q, kT, vT, k_scale, v_scale, bias=None, layer=None,
                    n_keys=None):
    stacked = layer is not None
    _build.require(q, "q", torch.bfloat16, 3)
    for name, a, dtype, nd in (("kT", kT, torch.int8, 4), ("vT", vT, torch.int8, 4),
                               ("k_scale", k_scale, torch.float32, 3),
                               ("v_scale", v_scale, torch.float32, 3)):
        _build.require(a, name, dtype, nd + stacked)
    b, h, dh = q.shape
    t = kT.shape[-1]
    lead = kT.shape[:1] if stacked else ()
    if kT.shape != lead + (b, h, dh, t) or vT.shape != kT.shape \
            or k_scale.shape != lead + (b, h, t) \
            or v_scale.shape != k_scale.shape \
            or (stacked and not 0 <= layer < kT.shape[0]):
        raise ValueError("decode_attention_hd_int8 shape mismatch")
    if bias is not None:
        _build.require(bias, "bias", torch.float32, 2)
        if bias.shape != (b, t):
            raise ValueError("bias must be (B, T)")
    n = _keys(t, n_keys)
    _check_keys(n, dh)
    out = torch.empty_like(q)
    fn = _build.bind("decode_attention_hd_int8",
                     "acai_decode_attention_hd_int8",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    rc = fn(q.data_ptr(), kT.data_ptr(), vT.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), 0 if bias is None else bias.data_ptr(),
            layer if stacked else 0, b, h, dh, t, n, 1.0 / math.sqrt(dh),
            out.data_ptr(), _build.stream_ptr())
    op.launched("stacked" if stacked else "layer")
    _build.check(rc, op.name)
    return out


decode_attention_hd_int8 = _build.KernelOp(
    "decode_attention_hd_int8",
    "acai_omr_tpu_torch/csrc/decode_attention_hd_int8.cu",
    "acai_omr_tpu/ops/pallas_decode.py:103 (_kernel_int8, pallas_call :374) "
    "and :274 (_kernel_int8_stacked, pallas_call :329)",
    _launch_hd_int8, decode_attention_hd_int8_plain)


def self_attention_append_int8_plain(q: torch.Tensor, k_new: torch.Tensor,
                                     v_new: torch.Tensor,
                                     k_cache: torch.Tensor,
                                     v_cache: torch.Tensor,
                                     k_scale: torch.Tensor,
                                     v_scale: torch.Tensor, layer: int,
                                     pos: int) -> torch.Tensor:
    """Plain twin of K13. q/k_new/v_new: (B, H, Dh); k_cache/v_cache:
    (L, B, H, Dh, T) int8 and k_scale/v_scale (L, B, H, T) fp32, whose column
    ``pos`` of layer ``layer`` is written in place with the fresh k / v
    quantized per head (fp32 scale ``max(amax, 1e-8) / 127``). Returns the
    attention (B, H, Dh) over positions < pos plus the fresh token, whose
    logit and value come from its quantized-dequantized k / v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qv = q.float()
    kq, ksc = quantize_rows(k_new)
    vq, vsc = quantize_rows(v_new)
    k_cache[layer, ..., pos] = kq
    v_cache[layer, ..., pos] = vq
    k_scale[layer, ..., pos] = ksc
    v_scale[layer, ..., pos] = vsc
    ksc, vsc = ksc[..., None], vsc[..., None]
    logits = torch.einsum("bhd,bhdt->bht", qv,
                          k_cache[layer, ..., :pos].float()) * scale
    logits = logits * k_scale[layer, ..., :pos]
    lc = (qv * (kq.float() * ksc)).sum(dim=-1, keepdim=True) * scale
    m = torch.maximum(logits.amax(dim=-1, keepdim=True), lc) if pos else lc
    w = torch.exp(logits - m)
    wc = torch.exp(lc - m)
    denom = w.sum(dim=-1, keepdim=True) + wc
    w = w * v_scale[layer, ..., :pos]
    out = torch.einsum("bht,bhdt->bhd", w, v_cache[layer, ..., :pos].float())
    return ((out + wc * (vq.float() * vsc)) / denom).to(q.dtype)


def _launch_append(op, q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                   layer, pos):
    for name, a in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        _build.require(a, name, torch.bfloat16, 3)
    for name, a, dtype, nd in (("k_cache", k_cache, torch.int8, 5),
                               ("v_cache", v_cache, torch.int8, 5),
                               ("k_scale", k_scale, torch.float32, 4),
                               ("v_scale", v_scale, torch.float32, 4)):
        _build.require(a, name, dtype, nd)
    b, h, dh = q.shape
    nl, t = k_cache.shape[0], k_cache.shape[-1]
    if k_new.shape != q.shape or v_new.shape != q.shape \
            or k_cache.shape != (nl, b, h, dh, t) \
            or v_cache.shape != k_cache.shape \
            or k_scale.shape != (nl, b, h, t) \
            or v_scale.shape != k_scale.shape \
            or not 0 <= layer < nl or not 0 <= pos < t:
        raise ValueError("self_attention_append_int8 shape mismatch")
    _check_keys(max(pos, 1), dh)
    out = torch.empty_like(q)
    fn = _build.bind("self_attention_append_int8",
                     "acai_self_attention_append_int8",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), layer, b, h, dh, t, pos, 1.0 / math.sqrt(dh),
            out.data_ptr(), _build.stream_ptr())
    op.launches += 1
    _build.check(rc, op.name)
    return out


self_attention_append_int8 = _build.KernelOp(
    "self_attention_append_int8",
    "acai_omr_tpu_torch/csrc/self_attention_append_int8.cu",
    "acai_omr_tpu/ops/pallas_decode.py:154 (_self_attn_append_kernel, "
    "wrapper :205, pallas_call :259)",
    _launch_append, self_attention_append_int8_plain)
