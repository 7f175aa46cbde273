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
(``csrc/decode_attention.cu``): the keys of a (row, head) split across a
thread-block cluster as :func:`decode_attention_plan` says, counted as
``"split{s}"`` in ``KernelOp.variants``; ``variant="simt"`` forces the
kernel it replaced (one block per (row, head)), kept as the yardstick and
launched by no path. int8 caches (the monolith's quantized mode):
ATT = K6 ``decode_attention_int8`` (``csrc/decode_attention_int8.cu``), which
quantizes q/k/v per (row, head), appends the int8 rows and their scales, and
attends with integer products and quantized softmax weights, on K2's cluster
design (:func:`decode_attention_int8_plan`, counted as ``"split{s}"``;
``variant="simt"`` forces the kernel it replaced, launched by no path). LIN = K1
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
import, default on; :func:`set_enabled`) is on and :func:`monolith_takes`
says that every op of the step takes the decoder's shapes on the device,
and the per-op step of :mod:`..models.decode` otherwise, as the JAX
package's ``use_monolith`` checks its own kernel's shapes (its lane
conditions are TPU limits and are not carried over). The ops' own checks
stay as strict: the gate is decided before a decode from the rules they
enforce.

Under int8 caches the weights follow two more switches, read at import as
the JAX package reads them: ``ACAI_W8A8_DECODE`` (default on;
:func:`set_w8a8`) and ``ACAI_W4A8_DECODE`` (default off; :func:`set_w4a8`),
resolved by :func:`weight_quant_mode`. With both off, int8 caches run K6
with compute-dtype weights (K1).

Tensor parallelism (``decode_layers(..., tp_group=)``, the JAX kernel's
``tp`` mode): every rank runs the layer over its heads and MLP columns, its
three row-parallel products stop at fp32 partials, and K15 ``tp_allreduce``
(:mod:`.tp_allreduce_kernel`) sums them across the ranks before the
residual LayerNorm: ``tp * 11 + 3`` wrapper calls a layer. Its weights stay
in the compute dtype unless ``ACAI_TP_W8A8`` (:func:`set_tp_w8a8`) opts into
per-shard W8A8; W4A8 never runs there.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

from . import _build
from .layernorm_kernel import add_layernorm, layernorm_takes
from .linear_kernel import N_SMS, linear_bias_act, linear_takes
from .quant_linear_kernel import (INT4_QMAX, INT8_QMAX, pack_k4, pack_k8_int4,
                                  quant4_linear_bias_act, quant4_takes,
                                  quant8_takes, quant_linear_bias_act)
from .tp_allreduce_kernel import LOCAL_ELEMS, tp_allreduce

Params = dict

# the most keys of an int8 cache or memory the monolith step takes (the simt
# K6 keeps one fp32 logit per key in 48 KB of shared memory)
MAX_INT8_KEYS = 8192
# K2, K6 and K11: a block's keys are whole units of ATTN_UNIT; blocks a
# cluster at most (a portable cluster); the shared memory a block's logits
# may take (K2, K11), a block's per-key shared memory (K6: G fp32 logits, G
# int8 weights and two bf16 scales a key); the blocks an SM (K2 / K11, K6)
# and the units a block the plan aims at; the head dims K2's and K6's
# kernels are compiled for
ATTN_UNIT = 16
ATTN_MAX_SPLIT = 8
ATTN_LOGIT_BYTES = 96 * 1024
ATTN_INT8_KEY_BYTES = 96 * 1024
ATTN_BLOCKS_PER_SM = 2
ATTN_INT8_BLOCKS_PER_SM = 4
ATTN_BLOCK_UNITS = 32
ATTN_DHS = (32, 64, 128)
_MATS = ("w_qkv", "w_self_out", "w_cross_q", "w_cross_out", "w_ff1", "w_ff2")

_ENABLED = os.environ.get("ACAI_MONOLITH_DECODE", "1") == "1"
_W8A8 = os.environ.get("ACAI_W8A8_DECODE", "1") == "1"
_W4A8 = os.environ.get("ACAI_W4A8_DECODE", "0") == "1"
_TP_W8A8 = os.environ.get("ACAI_TP_W8A8", "0") == "1"


def set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = flag


def set_w8a8(flag: bool) -> None:
    global _W8A8
    _W8A8 = flag


def set_w4a8(flag: bool) -> None:
    global _W4A8
    _W4A8 = flag


def set_tp_w8a8(flag: bool) -> None:
    global _TP_W8A8
    _TP_W8A8 = flag


def want_tp_w8a8() -> bool:
    """Whether tensor-parallel shards run W8A8 (``ACAI_TP_W8A8=1``, default
    off). Per-shard weight scales and per-row activation maxes over the
    shard's half of the contraction axis make it another quantization than
    the single-device W8A8, so it is an opt-in, as in the JAX package."""
    return _TP_W8A8


def weight_quant_mode(cache_dtype, tp_mono: bool = False):
    """The weights of the monolith step under ``cache_dtype``: ``"int4"``
    (W4A8, ``ACAI_W4A8_DECODE``), ``"int8"`` (W8A8, ``ACAI_W8A8_DECODE``) or
    False (compute dtype). Only int8 caches quantize the weights, and W4A8
    wins over W8A8, as the JAX package's ``weight_quant_mode``. Under tensor
    parallelism (``tp_mono``) the weights stay in the compute dtype unless
    both ``ACAI_W8A8_DECODE`` and ``ACAI_TP_W8A8`` are on; W4A8 never runs
    there."""
    if cache_dtype != torch.int8:
        return False
    if tp_mono:
        return "int8" if (_W8A8 and want_tp_w8a8()) else False
    if _W4A8:
        return "int4"
    return "int8" if _W8A8 else False


def use_monolith() -> bool:
    """The switch of this module's step (time-major caches) against the
    per-op step (lane-major caches); :func:`monolith_takes` is the shape
    gate beside it."""
    return _ENABLED


def int8_step_takes(head_dim: int, max_keys: int) -> bool:
    """The int8-cache rule of the step, on either device: a power-of-two
    head dim (the JAX monolith's rolling-max quantization) and at most
    MAX_INT8_KEYS keys of a cache or memory."""
    return head_dim > 0 and not head_dim & (head_dim - 1) \
        and max_keys <= MAX_INT8_KEYS


def monolith_takes(e: int, heads: int, mlp_dim: int, cache_dtype,
                   compute_dtype, max_keys: int, mem_len: int, device,
                   mem_group: int = 1, tp: int = 1) -> bool:
    """Whether every op of the step takes a decoder of width ``e``,
    ``heads`` heads and MLP width ``mlp_dim`` on ``device``, with caches of
    ``cache_dtype`` up to ``max_keys`` positions, a memory of ``mem_len``
    rows shared by ``mem_group`` rows, and ``tp`` tensor-parallel ranks: K1,
    K5 or K14 (as :func:`weight_quant_mode` picks), K2 or K6, K4 and K15.

    Built from the rules the ops enforce. Those their checks enforce on
    either device hold on the CPU too: K4's width (``layernorm_takes``),
    K15's (E % LOCAL_ELEMS), the int8 step's power-of-two head dim and
    MAX_INT8_KEYS (:func:`int8_step_takes`) and the keys a cluster holds
    (:func:`attention_fits`). The launchers' rules hold on a ``cuda``
    device only, so the twins keep taking the CPU's tiny shapes: a bf16
    compute dtype, a head dim of ATTN_DHS, the products' shapes
    (``linear_takes``, ``quant8_takes``, ``quant4_takes``). The decode loops
    take the per-op step where it is False, as the JAX package's
    ``use_monolith`` falls back."""
    if heads <= 0 or e % heads or heads % tp or mlp_dim % tp:
        return False
    dh = e // heads
    quantized = cache_dtype == torch.int8
    if not layernorm_takes(e) or (tp > 1 and e % LOCAL_ELEMS):
        return False
    if quantized and not int8_step_takes(dh, max(max_keys, mem_len)):
        return False
    if not (attention_fits(max(max_keys - 1, 0), 1, quantized)
            and attention_fits(mem_len, mem_group, quantized)):
        return False
    if torch.device(device).type != "cuda":
        return True
    if compute_dtype != torch.bfloat16 or dh not in ATTN_DHS:
        return False
    el, fl = e // tp, mlp_dim // tp
    mode = weight_quant_mode(cache_dtype, tp > 1)
    takes = quant4_takes if mode == "int4" else quant8_takes if mode \
        else (lambda k, n: linear_takes("skinny", k, n))
    return all(takes(k, n) for k, n in ((e, 3 * el), (el, e), (e, el),
                                        (el, e), (e, fl), (fl, e)))


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


def query_group(mem_group: int) -> int:
    """Queries one cluster of K2 takes: the group of rows sharing a memory
    row (``mem_group``) rounded up to 1, 2, 4 or 8; larger groups take
    several clusters of 8."""
    return next(g for g in (1, 2, 4, 8) if g >= min(mem_group, 8))


def _units_a_block(mem_group: int, int8: bool) -> int:
    """The key units one block of K2 / K11 (``int8`` False) or of K6 holds
    in shared memory, for clusters of ``query_group(mem_group)`` queries."""
    gq = query_group(mem_group)
    if int8:
        return ATTN_INT8_KEY_BYTES // (5 * gq + 4) // ATTN_UNIT
    return ATTN_LOGIT_BYTES // (4 * gq) // ATTN_UNIT


def attention_fits(n_keys: int, mem_group: int = 1,
                   int8: bool = False) -> bool:
    """Whether the cluster kernels (K2 / K11, or K6 with ``int8``) hold
    ``n_keys`` keys in the shared memory of ATTN_MAX_SPLIT blocks: the rule
    :func:`_split_keys` raises on, at the widest split."""
    units = max(1, -(-n_keys // ATTN_UNIT))
    return -(-units // ATTN_MAX_SPLIT) <= _units_a_block(mem_group, int8)


def decode_attention_plan(rows: int, heads: int, n_keys: int,
                          mem_group: int = 1,
                          int8: bool = False) -> tuple[int, int]:
    """(keys of a block's largest range, split) of K2 and K11, or of K6
    with ``int8`` (:func:`decode_attention_int8_plan`).

    One thread-block cluster of ``split`` blocks per (row, head), or per
    (memory row, head, up to 8 of its ``mem_group`` queries); the keys are
    U = ceil(n_keys / ATTN_UNIT) units and block r owns units
    [r U / split, (r + 1) U / split): ranges in order, none empty (``n_keys``
    0 takes one block of no keys). The split aims at about
    ATTN_BLOCKS_PER_SM blocks an SM and at most ATTN_BLOCK_UNITS units a
    block, as far as the units and a cluster of ATTN_MAX_SPLIT allow, so
    clusters x split reaches the 132 SMs wherever it can; it takes at least
    what a block's keys need in shared memory (ATTN_LOGIT_BYTES of logits,
    or ATTN_INT8_KEY_BYTES for K6) and raises ValueError past 8 blocks'
    worth. Timed on an H100 at every split (``chip_smoke.py
    --attn-splits``), this rule gave K2's and K11's fastest split or one
    within 13 % of it at all 24 decode shapes; one block an SM, the rule
    first tried, was up to 23 % slower at 4-16 rows."""
    gq = query_group(mem_group)
    clusters = rows // mem_group * -(-mem_group // gq) * heads
    units = max(1, -(-n_keys // ATTN_UNIT))
    most = _units_a_block(mem_group, int8)
    per_sm = ATTN_INT8_BLOCKS_PER_SM if int8 else ATTN_BLOCKS_PER_SM
    split = min(ATTN_MAX_SPLIT, units,
                max(per_sm * N_SMS // max(clusters, 1),
                    -(-units // ATTN_BLOCK_UNITS), -(-units // most)))
    return _split_keys(units, split, most, n_keys)


def decode_attention_int8_plan(rows: int, heads: int, n_keys: int,
                               mem_group: int = 1) -> tuple[int, int]:
    """(keys of a block's largest range, split) of K6's cluster kernel:
    :func:`decode_attention_plan`'s rule (ranges of whole 16-key units in
    order, none empty; at most 8 blocks a cluster) at about
    ATTN_INT8_BLOCKS_PER_SM blocks an SM, a block's keys within
    ATTN_INT8_KEY_BYTES of shared memory at 5 G + 4 bytes a key. An int8
    key is half a bf16 key's bytes: timed at every split on an H100
    (``chip_smoke.py --int8-splits``, from HBM), K2's two blocks an SM left
    K6 up to 14 % slower than its fastest split at 4-16 rows; four blocks an
    SM were within 12 % of it at all ten decode shapes."""
    return decode_attention_plan(rows, heads, n_keys, mem_group, int8=True)


def _split_keys(units: int, split: int, most: int, n_keys: int):
    per = -(-units // split)
    if per > most:
        raise ValueError(f"{n_keys} keys do not fit the shared memory of "
                         f"{split} blocks")
    return per * ATTN_UNIT, split


@functools.lru_cache(maxsize=4096)
def attention_split(variant, rows: int, heads: int, n_keys: int,
                    mem_group: int = 1, int8: bool = False):
    """(keys of the largest range, split) of a K2 / K11 call, or of a K6
    call with ``int8``: the plan's, or ``variant`` ``"split{s}"`` forced
    (fewer blocks where the keys are fewer units than s); None for
    ``"simt"``. Raises ValueError on an unknown variant or a split whose
    blocks' keys do not fit. Cached: the decode step asks for the same few
    shapes every step."""
    if variant is None:
        return decode_attention_plan(rows, heads, n_keys, mem_group, int8)
    if variant == "simt":
        return None
    s = variant[5:] if variant.startswith("split") else ""
    if not (s.isdigit() and 1 <= int(s) <= ATTN_MAX_SPLIT):
        raise ValueError(f"unknown variant {variant!r}: 'simt' or "
                         f"'split1' .. 'split{ATTN_MAX_SPLIT}'")
    units = max(1, -(-n_keys // ATTN_UNIT))
    return _split_keys(units, min(int(s), units),
                       _units_a_block(mem_group, int8), n_keys)


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


def _check(q, k_layer, v_layer, num_heads, pos=None, bias=None,
           mem_group=1, variant=None):
    """K2's shape rules and its variant, on either device: the plan
    (keys a block, split), or None for ``"simt"``."""
    if q.dim() != 2 or k_layer.dim() != 3 or v_layer.shape != k_layer.shape:
        raise ValueError("decode_attention shape mismatch")
    bm, t, e = k_layer.shape
    b = q.shape[0]
    if mem_group < 1 or bm * mem_group != b or e % num_heads:
        raise ValueError("decode_attention shape mismatch")
    if pos is not None:
        if q.shape[1] != 3 * e or bias is not None or not 0 <= pos < t \
                or mem_group != 1:
            raise ValueError("self mode needs (B, 3E) qkv, 0 <= pos < T, "
                             "no bias, mem_group 1")
    elif bias is None or q.shape[1] != e or tuple(bias.shape) != (bm, t):
        raise ValueError("cross mode needs (B, E) q and (B/G, M) bias")
    return attention_split(variant, b, num_heads, t if pos is None else pos,
                           mem_group)


def _launch(op, q, k_layer, v_layer, num_heads, pos=None, bias=None,
            mem_group=1, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"split{s}"`` forces
    the cluster kernel's split, ``"simt"`` the kernel it replaced."""
    plan = _check(q, k_layer, v_layer, num_heads, pos, bias, mem_group,
                  variant)
    _build.require(q, "q", torch.bfloat16, 2)
    _build.require(k_layer, "k_layer", torch.bfloat16, 3)
    _build.require(v_layer, "v_layer", torch.bfloat16, 3)
    bm, t, e = k_layer.shape
    b = q.shape[0]
    dh = e // num_heads
    if dh not in ATTN_DHS:
        raise ValueError("decode_attention shape mismatch: head dim "
                         f"{dh} is not 32, 64 or 128")
    if k_layer.data_ptr() % 16 or v_layer.data_ptr() % 16:
        raise ValueError("decode_attention needs 16-byte aligned caches")
    fresh = pos is not None
    if fresh:
        k_new, v_new, n_keys, bias_ptr = (q.data_ptr() + 2 * e,
                                          q.data_ptr() + 4 * e, pos, 0)
    else:
        _build.require(bias, "bias", torch.float32, 2)
        k_new = v_new = 0
        n_keys, bias_ptr = t, bias.data_ptr()
    out = torch.empty((b, e), dtype=torch.bfloat16, device=q.device)
    args = (q.data_ptr(), q.shape[1], k_new, v_new, k_layer.data_ptr(),
            v_layer.data_ptr(), b, num_heads, dh, t, n_keys, bias_ptr,
            -1 if pos is None else pos, mem_group, 1.0 / math.sqrt(dh))
    types = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_float]
    if plan is None:
        fn = _build.bind("decode_attention", "acai_decode_attention",
                         types + [ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, out.data_ptr(), _build.stream_ptr())
        op.launched("simt")
    else:
        chunk, split = plan
        fn = _build.bind("decode_attention", "acai_decode_attention_cluster",
                         types + [ctypes.c_int] * 2
                         + [ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, chunk, split, out.data_ptr(), _build.stream_ptr())
        op.launched(f"split{split}")
    _build.check(rc, op.name)
    return out


decode_attention = _build.KernelOp(
    "decode_attention", "acai_omr_tpu_torch/csrc/decode_attention.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:825 (_attend_all, self and cross "
    "sites of _kernel :997) and :932 (_attend_shared, bf16 branch)",
    _launch, decode_attention_plain, _check)


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


def _check_int8(q, k_layer, v_layer, k_scale, v_scale, num_heads, pos=None,
                bias=None, mem_group=1, variant=None):
    """K6's shape rules and its variant, on either device: the plan (keys a
    block, split), or None for ``"simt"``. The head dims the kernels are
    compiled for (ATTN_DHS) and MAX_INT8_KEYS are the launcher's rules."""
    if q.dim() != 2 or k_layer.dim() != 3 or v_layer.shape != k_layer.shape:
        raise ValueError("decode_attention_int8 shape mismatch")
    bm, t, e = k_layer.shape
    b = q.shape[0]
    if mem_group < 1 or bm * mem_group != b or e % num_heads \
            or tuple(k_scale.shape) != (bm, t, num_heads) \
            or v_scale.shape != k_scale.shape:
        raise ValueError("decode_attention_int8 shape mismatch")
    if pos is not None:
        if q.shape[1] != 3 * e or bias is not None or not 0 <= pos < t \
                or mem_group != 1:
            raise ValueError("self mode needs (B, 3E) qkv, 0 <= pos < T, "
                             "no bias, mem_group 1")
    elif bias is None or q.shape[1] != e or tuple(bias.shape) != (bm, t):
        raise ValueError("cross mode needs (B, E) q and (B/G, M) bias")
    return attention_split(variant, b, num_heads, t if pos is None else pos,
                           mem_group, int8=True)


def _launch_int8(op, q, k_layer, v_layer, k_scale, v_scale, num_heads,
                 pos=None, bias=None, mem_group=1, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"split{s}"`` forces
    the cluster kernel's split, ``"simt"`` the kernel it replaced."""
    plan = _check_int8(q, k_layer, v_layer, k_scale, v_scale, num_heads, pos,
                       bias, mem_group, variant)
    _build.require(q, "q", torch.bfloat16, 2)
    _build.require(k_layer, "k_layer", torch.int8, 3)
    _build.require(v_layer, "v_layer", torch.int8, 3)
    _build.require(k_scale, "k_scale", torch.bfloat16, 3)
    _build.require(v_scale, "v_scale", torch.bfloat16, 3)
    bm, t, e = k_layer.shape
    b = q.shape[0]
    dh = e // num_heads
    if dh not in ATTN_DHS or t > MAX_INT8_KEYS:
        raise ValueError("decode_attention_int8 shape mismatch: head dim "
                         f"{dh} (32, 64 or 128), {t} keys (at most "
                         f"{MAX_INT8_KEYS})")
    if k_layer.data_ptr() % 16 or v_layer.data_ptr() % 16:
        raise ValueError("decode_attention_int8 needs 16-byte aligned caches")
    if pos is not None:
        n_keys, bias_ptr = pos, 0
    else:
        _build.require(bias, "bias", torch.float32, 2)
        n_keys, bias_ptr = t, bias.data_ptr()
    out = torch.empty((b, e), dtype=torch.bfloat16, device=q.device)
    args = (q.data_ptr(), q.shape[1], k_layer.data_ptr(), v_layer.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), b, num_heads, dh, t,
            n_keys, bias_ptr, -1 if pos is None else pos, mem_group,
            1.0 / math.sqrt(dh))
    types = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_float]
    if plan is None:
        fn = _build.bind("decode_attention_int8",
                         "acai_decode_attention_int8",
                         types + [ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, out.data_ptr(), _build.stream_ptr())
        op.launched("simt")
    else:
        chunk, split = plan
        fn = _build.bind("decode_attention_int8",
                         "acai_decode_attention_int8_cluster",
                         types + [ctypes.c_int] * 2
                         + [ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, chunk, split, out.data_ptr(), _build.stream_ptr())
        op.launched(f"split{split}")
    _build.check(rc, op.name)
    return out


decode_attention_int8 = _build.KernelOp(
    "decode_attention_int8",
    "acai_omr_tpu_torch/csrc/decode_attention_int8.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:725 (_quant_rows), :825 / :859-917 "
    "(_attend_all, int8 branch), :1380-1432 (quantized append), :1466-1473 "
    "(cross site), :932 / :951-986 (_attend_shared, int8 branch)",
    _launch_int8, decode_attention_int8_plain, _check_int8)


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
    tells :func:`decode_layers` to take K14.

    A tensor-parallel shard's params (:mod:`..parallel.sharding`) pack the
    same way at the shard's widths; int8 column scales then span the shard's
    rows of the row-parallel matrices only."""
    if quantize_weights not in (False, True, "int8", "int4"):
        raise ValueError(f"unsupported weight mode {quantize_weights!r}")
    qmax, pack = (INT4_QMAX, pack_k8_int4) if quantize_weights == "int4" \
        else (INT8_QMAX, pack_k4)
    blocks = params["blocks"]
    sa, ca = blocks["self_attn"], blocks["cross_attn"]
    # the attention width: E, or a tensor-parallel shard's E / tp (its q
    # columns lead its [q_i|k_i|v_i] block)
    e = sa["in_kernel"].shape[-1] // 3
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


def _step_ops(mono: Params, x: torch.Tensor, k_cache: torch.Tensor,
              mem_k: torch.Tensor, num_heads: int, quantized: bool,
              mem_group: int, plain: bool):
    """Checks one device's (or one rank's) operands and picks the step's
    ops: (product, attention, add-LayerNorm, whether the weights are
    quantized)."""
    w_quant = "s_qkv" in mono
    if w_quant and not quantized:
        raise ValueError("W8A8 / W4A8 weights need int8 caches")
    b = x.shape[0]
    e = k_cache.shape[-1]
    if mem_k.shape[1] * mem_group != b:
        raise ValueError(f"mem rows {mem_k.shape[1]} x group {mem_group} "
                         f"!= batch {b}")
    if quantized:
        dh = e // num_heads
        if dh * num_heads != e or not int8_step_takes(dh, 1):
            raise ValueError(f"int8 caches need a power-of-two head dim, got "
                             f"E={e}, heads={num_heads}")
        if not int8_step_takes(dh, max(k_cache.shape[2], mem_k.shape[2])):
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
    return lin, attn, ln, w_quant


def decode_layers(mono, x, pos: int, k_cache, v_cache, mem_k, mem_v,
                  mem_bias, num_heads: int, plain: bool = False,
                  k_scale=None, v_scale=None, mem_k_scale=None,
                  mem_v_scale=None, mem_group: int = 1, tp_group=None):
    """One token through every decoder layer.

    x: (B, E) embedded token in the compute dtype; k_cache/v_cache:
    (L, B, T, E), appended in place at ``pos``; mem_k/mem_v: (L, B/G, M, E);
    mem_bias: (B/G, M) fp32 additive padding bias. With int8 caches pass the
    bf16 scales k_scale/v_scale (L, B, T, H), appended in place too, and
    mem_k_scale/mem_v_scale (L, B/G, M, H). ``mono`` from :func:`prepack`
    decides the products: int8 weights run W8A8 (K5), int4 weights W4A8
    (K14); both need int8 caches, as in the JAX package. Returns (B, E).

    ``tp_group`` (a :class:`..tp_allreduce_kernel.TPGroup`): the
    tensor-parallel step of the JAX kernel's ``tp`` mode. Every operand but
    ``pos`` is then a sequence with one entry per rank, on that rank's device:
    the rank's :func:`prepack` of its shard, its copy of x, its caches and
    memory over its ``num_heads`` heads (E / tp wide). Each rank runs its
    layer; the three row-parallel products (self out, cross out, ff2) stop
    at fp32 partials without bias (K1 / K5 ``"partial"``), and K15
    ``tp_allreduce`` sums them, adds the bias and rounds to the compute dtype
    for every rank before K4. Returns one (B, E) x per rank, equal in every
    bit.

    On CUDA tensors every op is a kernel launch (K1, K5 or K14, K2 or K6,
    K4, K15); on CPU tensors the plain twins run. ``plain=True`` runs the
    plain twins on any device.
    """
    tp = 1 if tp_group is None else tp_group.tp

    def ranks(a):  # one entry per rank
        if tp_group is None:
            return [a]
        return [None] * tp if a is None else list(a)

    monos, xs, kcs, vcs = ranks(mono), ranks(x), ranks(k_cache), \
        ranks(v_cache)
    mks, mvs, mbs = ranks(mem_k), ranks(mem_v), ranks(mem_bias)
    kss, vss, mkss, mvss = ranks(k_scale), ranks(v_scale), \
        ranks(mem_k_scale), ranks(mem_v_scale)
    quantized = kss[0] is not None
    # every rank's operands are checked; the ranks share one set of ops
    lin, attn, ln, w_quant = [
        _step_ops(monos[r], xs[r], kcs[r], mks[r], num_heads, quantized,
                  mem_group, plain) for r in range(tp)][0]
    reduce = tp_allreduce.plain if plain else tp_allreduce

    def mat(r, xv, i, name, act="none"):
        p = monos[r]
        w = (p["w_" + name][i],)
        if w_quant:
            w += (p["s_" + name][i],)
        return lin(xv, *w, None if act == "partial" else p["b_" + name][i],
                   act)

    def row_parallel(parts, i, name):
        """The summed output of a row-parallel product (+ bias, rounded)."""
        if tp == 1:
            return [parts[0]]
        return reduce(parts, tp_group, [p["b_" + name][i] for p in monos],
                      xs[0].dtype)

    def residual_ln(ys, i, k):
        return [ln(xs[r], ys[r], monos[r][f"ln{k}_g"][i],
                   monos[r][f"ln{k}_b"][i], 1e-5) for r in range(tp)]

    out_act = "none" if tp == 1 else "partial"
    for i in range(kcs[0].shape[0]):
        parts = []
        for r in range(tp):
            self_kv = (kcs[r][i], vcs[r][i])
            if quantized:
                self_kv += (kss[r][i], vss[r][i])
            a = attn(mat(r, xs[r], i, "qkv"), *self_kv, num_heads, pos=pos)
            parts.append(mat(r, a, i, "self_out", out_act))
        xs = residual_ln(row_parallel(parts, i, "self_out"), i, 1)
        parts = []
        for r in range(tp):
            mem_kv = (mks[r][i], mvs[r][i])
            if quantized:
                mem_kv += (mkss[r][i], mvss[r][i])
            c = attn(mat(r, xs[r], i, "cross_q"), *mem_kv, num_heads,
                     bias=mbs[r], mem_group=mem_group)
            parts.append(mat(r, c, i, "cross_out", out_act))
        xs = residual_ln(row_parallel(parts, i, "cross_out"), i, 2)
        parts = [mat(r, mat(r, xs[r], i, "ff1", "gelu_rounded"), i, "ff2",
                     out_act) for r in range(tp)]
        xs = residual_ln(row_parallel(parts, i, "ff2"), i, 3)
    return xs if tp_group is not None else xs[0]
