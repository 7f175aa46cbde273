"""Single-query attention of the per-op decode step, as hand-written kernels.

Port of the JAX package's ``ops/pallas_decode.py``: the attention kernels of
the per-op ("lane-major") decode step, which keeps its caches as
``(L, B, H, Dh, T)`` planes with the time axis last. Three kernels:

* K11 :data:`decode_attention_hd` (``csrc/decode_attention_hd.cu``): q
  ``(B, H, Dh)`` against kT / vT ``(B, H, Dh, T)`` in the compute dtype, fp32
  softmax, the division after the V sum. The keys of a (row, head) are split
  across a thread-block cluster as :func:`..decode_kernel.decode_attention_plan`
  says, counted as ``"split{s}"``; ``variant="simt"``
  forces the kernel it replaced, kept as the yardstick.
* K12 :data:`decode_attention_hd_int8` (``csrc/decode_attention_hd_int8.cu``):
  the same over int8 planes with fp32 ``(B, H, T)`` scales, per layer or
  reading layer ``layer`` of a stacked ``(L, B, H, Dh, T)`` cache, on K11's
  cluster design (the keys split as
  :func:`..decode_kernel.decode_attention_int8_plan` says), counted as
  ``"layer_split{s}"`` / ``"stacked_split{s}"``; ``variant="simt"`` forces
  the kernel it replaced, kept as the yardstick.
* K13 :data:`self_attention_append_int8`
  (``csrc/self_attention_append_int8.cu``): quantizes the fresh k / v rows,
  writes them and their scales into column ``pos`` of layer ``layer`` in
  place, and attends over the positions before ``pos`` plus the fresh token,
  on K12's cluster kernel (``csrc/hd_int8_cluster.cuh``; the ``pos`` keys
  split as K12's are, pos 0 one block a (row, head) without a cluster),
  counted as ``"split{s}"``; ``variant="simt"`` forces the kernel it
  replaced, kept as the yardstick.

The switches mirror the JAX package's: ``ACAI_PALLAS_DECODE`` (K11,
default off) and ``ACAI_PALLAS_DECODE_INT8`` (K12 / K13, default on), read
at import, changed with :func:`set_enabled` / :func:`set_enabled_int8`. The
TPU shape and VMEM conditions of the JAX ``use_pallas`` are not carried
over; the card's own rule is the head dims the cluster kernels of K11-K13
are compiled for (:func:`hd_takes`), where the per-op step takes its plain
path instead, as JAX falls back.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import _build
from .decode_kernel import attention_split, quantize_rows

_ENABLED = os.environ.get("ACAI_PALLAS_DECODE", "0") == "1"
_ENABLED_INT8 = os.environ.get("ACAI_PALLAS_DECODE_INT8", "1") == "1"

# the simt forms of K11-K13 keep every logit (and the query) in shared
# memory: 227 KB a block at most (the cluster kernels hold a range of the
# keys a block: the plans' rules)
MAX_KEYS = 227 * 1024 // 4 - 3 * 128
# the head dims the cluster kernels of K11-K13 are compiled for
HD_DHS = (16, 32, 64, 128)


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


def hd_takes(dh: int, device) -> bool:
    """Whether K11-K13 take head dim ``dh`` on ``device``: on the card
    their cluster kernels are compiled for HD_DHS; on the CPU their twins
    take any. :func:`..models.decode.decode_attention` and the per-op
    step's self- and stacked cross-attention ask before they call K11, K12
    or K13 and take the plain path otherwise, as the JAX package's
    ``use_pallas`` falls back for the shapes its kernels do not take."""
    return torch.device(device).type != "cuda" or dh in HD_DHS


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


def _check_hd(q, kT, vT, bias=None, n_keys=None, variant=None):
    """K11's shape rules and its variant, on either device: the plan (keys
    a block, split), or None for ``"simt"``."""
    if q.dim() != 3 or kT.dim() != 4 or vT.shape != kT.shape \
            or tuple(kT.shape[:3]) != tuple(q.shape):
        raise ValueError("decode_attention_hd shape mismatch")
    b, h, dh, t = kT.shape
    if bias is not None and tuple(bias.shape) != (b, t):
        raise ValueError("bias must be (B, T)")
    n = _keys(t, n_keys)
    _check_keys(n, dh)
    return attention_split(variant, b, h, n)


def _launch_hd(op, q, kT, vT, bias=None, n_keys=None, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"split{s}"`` forces
    the cluster kernel's split, ``"simt"`` the kernel it replaced."""
    plan = _check_hd(q, kT, vT, bias, n_keys, variant)
    _build.require(q, "q", torch.bfloat16, 3)
    _build.require(kT, "kT", torch.bfloat16, 4)
    _build.require(vT, "vT", torch.bfloat16, 4)
    if bias is not None:
        _build.require(bias, "bias", torch.float32, 2)
    b, h, dh = q.shape
    t = kT.shape[-1]
    n = _keys(t, n_keys)
    if plan is not None and not hd_takes(dh, q.device):
        raise ValueError(f"decode_attention_hd's cluster kernel takes head "
                         f"dims {HD_DHS}, got {dh}")
    out = torch.empty_like(q)
    args = (q.data_ptr(), kT.data_ptr(), vT.data_ptr(),
            0 if bias is None else bias.data_ptr(), b, h, dh, t, n,
            1.0 / math.sqrt(dh))
    types = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
    if plan is None:
        fn = _build.bind("decode_attention_hd", "acai_decode_attention_hd",
                         types + [ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, out.data_ptr(), _build.stream_ptr())
        op.launched("simt")
    else:
        chunk, split = plan
        fn = _build.bind("decode_attention_hd",
                         "acai_decode_attention_hd_cluster",
                         types + [ctypes.c_int] * 2
                         + [ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, chunk, split, out.data_ptr(), _build.stream_ptr())
        op.launched(f"split{split}")
    _build.check(rc, op.name)
    return out


decode_attention_hd = _build.KernelOp(
    "decode_attention_hd", "acai_omr_tpu_torch/csrc/decode_attention_hd.cu",
    "acai_omr_tpu/ops/pallas_decode.py:77 (_kernel, pallas_call :382)",
    _launch_hd, decode_attention_hd_plain, _check_hd)


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


def _check_hd_int8(q, kT, vT, k_scale, v_scale, bias=None, layer=None,
                   n_keys=None, variant=None):
    """K12's shape rules and its variant, on either device: the plan (keys
    a block, split; the keys a cluster holds are the plan's rule), or None
    for ``"simt"`` (every logit in one block's shared memory)."""
    stacked = layer is not None
    if q.dim() != 3 or kT.dim() != 4 + stacked:
        raise ValueError("decode_attention_hd_int8 shape mismatch")
    b, h, dh = q.shape
    t = kT.shape[-1]
    lead = tuple(kT.shape[:1]) if stacked else ()
    if tuple(kT.shape) != lead + (b, h, dh, t) \
            or tuple(vT.shape) != tuple(kT.shape) \
            or tuple(k_scale.shape) != lead + (b, h, t) \
            or tuple(v_scale.shape) != tuple(k_scale.shape) \
            or (stacked and not 0 <= layer < kT.shape[0]):
        raise ValueError("decode_attention_hd_int8 shape mismatch")
    if bias is not None and tuple(bias.shape) != (b, t):
        raise ValueError("bias must be (B, T)")
    n = _keys(t, n_keys)
    if variant == "simt":
        _check_keys(n, dh)
    return attention_split(variant, b, h, n, 1, True)


def _launch_hd_int8(op, q, kT, vT, k_scale, v_scale, bias=None, layer=None,
                    n_keys=None, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"split{s}"`` forces
    the cluster kernel's split, ``"simt"`` the kernel it replaced. Launches
    count per layer and stacked apart: ``"layer_split{s}"`` /
    ``"stacked_split{s}"``, or ``"simt"``."""
    plan = _check_hd_int8(q, kT, vT, k_scale, v_scale, bias, layer, n_keys,
                          variant)
    stacked = layer is not None
    _build.require(q, "q", torch.bfloat16, 3)
    for name, a, dtype, nd in (("kT", kT, torch.int8, 4), ("vT", vT, torch.int8, 4),
                               ("k_scale", k_scale, torch.float32, 3),
                               ("v_scale", v_scale, torch.float32, 3)):
        _build.require(a, name, dtype, nd + stacked)
    if bias is not None:
        _build.require(bias, "bias", torch.float32, 2)
    b, h, dh = q.shape
    t = kT.shape[-1]
    n = _keys(t, n_keys)
    if plan is not None and not hd_takes(dh, q.device):
        raise ValueError(f"decode_attention_hd_int8's cluster kernel takes "
                         f"head dims {HD_DHS}, got {dh}")
    out = torch.empty_like(q)
    args = (q.data_ptr(), kT.data_ptr(), vT.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), 0 if bias is None else bias.data_ptr(),
            layer if stacked else 0, b, h, dh, t, n, 1.0 / math.sqrt(dh))
    types = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float]
    if plan is None:
        fn = _build.bind("decode_attention_hd_int8",
                         "acai_decode_attention_hd_int8",
                         types + [ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, out.data_ptr(), _build.stream_ptr())
        op.launched("simt")
    else:
        chunk, split = plan
        fn = _build.bind("decode_attention_hd_int8",
                         "acai_decode_attention_hd_int8_cluster",
                         types + [ctypes.c_int] * 2
                         + [ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, chunk, split, out.data_ptr(), _build.stream_ptr())
        op.launched(f"{'stacked' if stacked else 'layer'}_split{split}")
    _build.check(rc, op.name)
    return out


decode_attention_hd_int8 = _build.KernelOp(
    "decode_attention_hd_int8",
    "acai_omr_tpu_torch/csrc/decode_attention_hd_int8.cu",
    "acai_omr_tpu/ops/pallas_decode.py:103 (_kernel_int8, pallas_call :374) "
    "and :274 (_kernel_int8_stacked, pallas_call :329)",
    _launch_hd_int8, decode_attention_hd_int8_plain, _check_hd_int8)


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


def _check_append(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                  layer, pos, variant=None):
    """K13's shape rules and its variant, on either device: the plan of its
    ``pos`` keys (keys a block, split; K12's rule, pos 0 one block), or
    None for ``"simt"`` (every logit in one block's shared memory)."""
    if q.dim() != 3 or k_cache.dim() != 5:
        raise ValueError("self_attention_append_int8 shape mismatch")
    b, h, dh = q.shape
    nl, t = k_cache.shape[0], k_cache.shape[-1]
    if tuple(k_new.shape) != tuple(q.shape) \
            or tuple(v_new.shape) != tuple(q.shape) \
            or tuple(k_cache.shape) != (nl, b, h, dh, t) \
            or tuple(v_cache.shape) != tuple(k_cache.shape) \
            or tuple(k_scale.shape) != (nl, b, h, t) \
            or tuple(v_scale.shape) != tuple(k_scale.shape) \
            or not 0 <= layer < nl or not 0 <= pos < t:
        raise ValueError("self_attention_append_int8 shape mismatch")
    if variant == "simt":
        _check_keys(max(pos, 1), dh)
    return attention_split(variant, b, h, pos, 1, True)


def _launch_append(op, q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                   layer, pos, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"split{s}"`` forces
    the cluster kernel's split, ``"simt"`` the kernel it replaced."""
    plan = _check_append(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                         layer, pos, variant)
    for name, a in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        _build.require(a, name, torch.bfloat16, 3)
    for name, a, dtype, nd in (("k_cache", k_cache, torch.int8, 5),
                               ("v_cache", v_cache, torch.int8, 5),
                               ("k_scale", k_scale, torch.float32, 4),
                               ("v_scale", v_scale, torch.float32, 4)):
        _build.require(a, name, dtype, nd)
    b, h, dh = q.shape
    t = k_cache.shape[-1]
    if plan is not None and not hd_takes(dh, q.device):
        raise ValueError(f"self_attention_append_int8's cluster kernel takes "
                         f"head dims {HD_DHS}, got {dh}")
    out = torch.empty_like(q)
    args = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), layer, b, h, dh, t, pos, 1.0 / math.sqrt(dh))
    types = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float]
    if plan is None:
        fn = _build.bind("self_attention_append_int8",
                         "acai_self_attention_append_int8",
                         types + [ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, out.data_ptr(), _build.stream_ptr())
        op.launched("simt")
    else:
        chunk, split = plan
        fn = _build.bind("self_attention_append_int8",
                         "acai_self_attention_append_int8_cluster",
                         types + [ctypes.c_int] * 2
                         + [ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, chunk, split, out.data_ptr(), _build.stream_ptr())
        op.launched(f"split{split}")
    _build.check(rc, op.name)
    return out


self_attention_append_int8 = _build.KernelOp(
    "self_attention_append_int8",
    "acai_omr_tpu_torch/csrc/self_attention_append_int8.cu",
    "acai_omr_tpu/ops/pallas_decode.py:154 (_self_attn_append_kernel, "
    "wrapper :205, pallas_call :259)",
    _launch_append, self_attention_append_int8_plain, _check_append)
