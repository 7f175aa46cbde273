"""K5 ``quant_linear_bias_act`` and K14 ``quant4_linear_bias_act``: the
W8A8 and W4A8 products of the int8 decode step.

act(((int8(x) @ w8) * row_scale) * col_scale + b): each activation row is
quantized over its whole contraction axis (max-abs, fp32 scale, round half to
even), multiplied with the integer weights in exact int32 arithmetic, and
dequantized by the row scale, then by the weights' per-output-column scale.
``act="partial"`` returns the dequantized fp32 product without the bias: a
rank's share of a tensor-parallel row-parallel product (W8A8 under
``ACAI_TP_W8A8``), summed by K15 ``tp_allreduce``.

CUDA source: ``csrc/quant_linear.cu`` (bound, design and the TPU kernels they
replace are noted there). Both are one launch of one cluster kernel,
templated on the weight format (K split across a thread-block cluster, the
rows quantized in the kernel, ``mma.sync`` s8): K5 on :func:`quant8_plan`
(128 columns a block), K14 on :func:`quant4_plan` (64), counted as
``"split{s}"`` in ``KernelOp.variants`` (K5's tensor-parallel partials
apart, as ``"partial_split{s}"``); ``variant="simt"`` forces the
three-launch form they replaced (row quantizer, product, split-K reduce),
kept as the yardstick. The weights are held K-packed so that one 32-bit
word is a tensor-core fragment (K5) or two after unpacking (K14); the plain
twins read the same tensors.

* int8 (K5): four input rows a word, ``(IN/4, OUT, 4)`` int8
  (:func:`pack_k4` / :func:`unpack_k4`).
* int4 (K14): eight input rows a word, ``(IN/8, OUT)`` int32
  (:func:`pack_k8_int4` / :func:`unpack_k8_int4`). Byte ``j`` of the word of
  rows ``k .. k+7`` holds ``q[k+j] + 8`` in its low nibble and
  ``q[k+4+j] + 8`` in its high nibble, ``q`` in [-8, 7] (the decode's
  weights are quantized to [-7, 7]; the int4 probe draws -8 too). So
  ``(w & 0x0F0F0F0F) - 0x08080808`` (per byte) is the ``__dp4a`` operand of
  rows ``k .. k+3`` and ``((w >> 4) & 0x0F0F0F0F) - 0x08080808`` that of rows
  ``k+4 .. k+7``: the kernel unpacks in registers. The JAX package pairs
  nibbles along the shorter axis (``int4_pack_axis``) for the TPU's identity
  matmul unpack; that layout is not reproduced, the int4 values and scales
  are the same.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .linear_kernel import ACTS, N_SMS, _gelu32

INT8_QMAX = 127.0
INT4_QMAX = 7.0
_BN, _KSTAGE, _BM = 128, 128, 32
_TARGET_BLOCKS = 2 * 132  # two waves of blocks on an H100's 132 SMs
# the cluster kernel of K5 and K14: 64 output columns a block (K14; K5
# 128, or 64 forced: Q8_BNS), 32 rows and a range of K a block, k-steps of
# 128 through a ring of up to 8 stages, at most 1,024 k a block (its rows in
# shared memory), K split across at most one portable cluster; the blocks
# an SM their plans aim at (K14, K5)
Q4_BN, Q4_KSTEP, Q4_STAGES = 64, 128, 8
Q4_MAX_CHUNK, Q4_MAX_SPLIT = 1024, 8
Q4_ROWS = 32
Q4_BLOCKS_PER_SM = 2
Q8_BN, Q8_BNS = 128, (64, 128)
Q8_BLOCKS_PER_SM = 1


def pack_k4(w8: torch.Tensor) -> torch.Tensor:
    """(..., IN, OUT) int8 -> (..., IN/4, OUT, 4): four consecutive input
    rows of one output column side by side in memory."""
    *lead, k, n = w8.shape
    return w8.reshape(*lead, k // 4, 4, n).transpose(-1, -2).contiguous()


def unpack_k4(w4: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_k4`."""
    *lead, k4, n, _ = w4.shape
    return w4.transpose(-1, -2).reshape(*lead, k4 * 4, n)


def pack_k8_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., IN, OUT) int4 values in [-8, 7] (any integer dtype) ->
    (..., IN/8, OUT) int32 words, eight consecutive input rows each (layout
    in the module docstring)."""
    *lead, k, n = q.shape
    if k % 8:
        raise ValueError(f"int4 packing needs IN % 8 == 0, got {k}")
    u = (q.to(torch.int64) + 8).reshape(*lead, k // 8, 2, 4, n)
    byte = u[..., 0, :, :] | (u[..., 1, :, :] << 4)         # (..., k/8, 4, n)
    shifts = (8 * torch.arange(4, device=q.device)).view(4, 1)
    word = (byte << shifts).sum(dim=-2)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def unpack_k8_int4(w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_k8_int4`: (..., IN/8, OUT) int32 ->
    (..., IN, OUT) int8."""
    *lead, k8, n = w.shape
    u = w.to(torch.int64) & 0xFFFFFFFF
    shifts = (8 * torch.arange(4, device=w.device)).view(4, 1)
    byte = (u.unsqueeze(-2) >> shifts) & 0xFF                # (..., k/8, 4, n)
    halves = torch.stack([byte & 0xF, byte >> 4], dim=-3)   # (..., k/8, 2, 4, n)
    return (halves - 8).reshape(*lead, 8 * k8, n).to(torch.int8)


def quantize_activation_rows(x: torch.Tensor):
    """(M, K) -> (int-valued fp32 (M, K), fp32 row scale (M, 1)): max-abs over
    the whole row, scale not rounded, no clip (|x| / scale <= 127 already).
    The divisor 127 is a tensor: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, the kernels divide."""
    x32 = x.float()
    amax = x32.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)
    rs = amax / torch.full_like(amax, INT8_QMAX)
    return torch.round(x32 / rs), rs


def quant_linear_bias_act_plain(x: torch.Tensor, w4: torch.Tensor,
                                s_col: torch.Tensor, b: torch.Tensor,
                                act: str = "none") -> torch.Tensor:
    """Plain twin. x (M, K) compute dtype; w4 (K/4, N, 4) int8; s_col, b (N,)
    fp32. The integer product runs in float64, where it is exact."""
    return _qdot_bias_act(x, unpack_k4(w4), s_col, b, act)


def quant4_linear_bias_act_plain(x: torch.Tensor, wp: torch.Tensor,
                                 s_col: torch.Tensor, b: torch.Tensor,
                                 act: str = "none") -> torch.Tensor:
    """Plain twin of K14. x (M, K) compute dtype; wp (K/8, N) int32 packed
    int4 weights; s_col, b (N,) fp32. Unpacks to int8, then K5's twin."""
    return _qdot_bias_act(x, unpack_k8_int4(wp), s_col, b, act)


def _qdot_bias_act(x, w8, s_col, b, act):
    x8, rs = quantize_activation_rows(x)
    acc = torch.matmul(x8.double(), w8.double()).float()
    if act == "partial":  # a rank's fp32 share of a row-parallel product
        return (acc * rs) * s_col.float()
    u = (acc * rs) * s_col.float() + b.float()
    if act == "gelu":
        u = _gelu32(u)
    elif act == "gelu_rounded":
        u = _gelu32(u.to(x.dtype).float())
    elif act != "none":
        raise ValueError(f"unknown activation {act!r}")
    return u.to(x.dtype)


def split_plan(m: int, n: int, k: int) -> tuple[int, int]:
    """(k_chunk, splits) of the three-launch form (``variant="simt"``): K
    is split across blocks until about two waves of blocks stream the
    weights. int32 partial sums add up exactly in any order."""
    tiles = (n // _BN) * (-(-m // _BM))
    k_tiles = k // _KSTAGE
    splits = max(1, min(k_tiles, _TARGET_BLOCKS // max(tiles, 1)))
    chunk = -(-k_tiles // splits)
    return chunk * _KSTAGE, -(-k_tiles // chunk)


def _cluster_split(m: int, n: int, k: int, bn: int,
                   per_sm: int) -> tuple[int, int]:
    """(k_chunk, split) of the cluster kernel at ``bn`` columns a block: a
    block owns bn columns, up to Q4_ROWS rows and k_chunk of K (a multiple
    of Q4_KSTEP, at most Q4_MAX_CHUNK); the ``split`` blocks of one (column
    tile, row group) form one cluster and sum their exact int32 partials,
    ranges in order and none empty. The split aims at about ``per_sm``
    blocks an SM (every block also loads and quantizes its range of the
    rows, so the work a block shrinks as the split widens), as far as the
    k-steps and a cluster of Q4_MAX_SPLIT allow."""
    tiles = -(-n // bn) * -(-m // Q4_ROWS)
    steps = k // Q4_KSTEP
    want = min(Q4_MAX_SPLIT, steps,
               max(-(-steps // (Q4_MAX_CHUNK // Q4_KSTEP)),
                   -(-per_sm * N_SMS // tiles)))
    chunk = -(-steps // want)
    return chunk * Q4_KSTEP, -(-steps // chunk)


def quant4_plan(m: int, n: int, k: int) -> tuple[int, int]:
    """(k_chunk, split) of K14's cluster kernel for an M x K by K x N
    product, Q4_BN columns a block (:func:`_cluster_split`). Timed at every
    split on an H100 (``chip_smoke.py --int8-splits``, from HBM), this
    rule's split was within 5 % of the fastest at all six decode shapes.
    Raises ValueError on shapes the kernel does not take
    (:func:`quant4_takes`)."""
    if not quant4_takes(k, n):
        raise ValueError(f"quant4_linear_bias_act takes K % {_KSTAGE} == 0, "
                         f"K <= {Q4_MAX_SPLIT * Q4_MAX_CHUNK} and N % {_BN} "
                         f"== 0, got K={k}, N={n}")
    return _cluster_split(m, n, k, Q4_BN, Q4_BLOCKS_PER_SM)


def quant8_plan(m: int, n: int, k: int) -> tuple[int, int, int]:
    """(k_chunk, split, bn) of K5's cluster kernel for an M x K by K x N
    product: Q8_BN columns a block and :func:`_cluster_split` at about
    Q8_BLOCKS_PER_SM blocks an SM. Timed on an H100 at every split and both
    widths (``chip_smoke.py --int8-splits``, from HBM, the thirteen W8A8
    shapes of the paths), the 128-column tile was the faster at eleven and
    one block an SM beat two wherever they differ: K5's columns carry twice
    K14's weight bytes, and a wider tile halves the clusters that load and
    quantize the rows again. This rule was within 5 % of the fastest at all
    thirteen. Raises ValueError on shapes the kernel does not take
    (:func:`quant8_takes`)."""
    if not quant8_takes(k, n):
        raise ValueError(f"quant_linear_bias_act takes K % {_KSTAGE} == 0, "
                         f"K <= {Q4_MAX_SPLIT * Q4_MAX_CHUNK} and N % {_BN} "
                         f"== 0, got K={k}, N={n}")
    return (*_cluster_split(m, n, k, Q8_BN, Q8_BLOCKS_PER_SM), Q8_BN)


def quant_takes(k: int, n: int) -> bool:
    """The shape rule K5 and K14 share on the card (every form, the
    three-launch ones included): K % 128 == 0 and N % 128 == 0."""
    return k % _KSTAGE == 0 and n % _BN == 0 and k > 0 and n > 0


def quant4_takes(k: int, n: int) -> bool:
    """K14's shape rule on the card: :func:`quant_takes`, and K within
    Q4_MAX_SPLIT blocks of Q4_MAX_CHUNK (the cluster kernel's rows in shared
    memory)."""
    return quant_takes(k, n) and k <= Q4_MAX_SPLIT * Q4_MAX_CHUNK


def quant8_takes(k: int, n: int) -> bool:
    """K5's shape rule on the card: its cluster kernel is K14's on int8
    weights, so the rule is :func:`quant4_takes`.
    ``decode_kernel.monolith_takes`` reads it for W8A8 weights."""
    return quant4_takes(k, n)


def _unknown(variant, forms: str):
    return ValueError(f"unknown variant {variant!r}: 'simt', "
                      f"'split1' .. 'split{Q4_MAX_SPLIT}'{forms}")


def _forced_split(variant, s: str, k: int) -> tuple[int, int]:
    """(k_chunk, split) with the split ``s`` forced (fewer blocks where K
    has fewer k-steps, or where a cluster of Q4_MAX_SPLIT needs more k a
    block); ValueError where a block's range is past its shared memory."""
    if not (s.isdigit() and 1 <= int(s) <= Q4_MAX_SPLIT):
        raise _unknown(variant, "")
    steps = k // Q4_KSTEP
    chunk = max(-(-steps // int(s)), -(-steps // Q4_MAX_SPLIT))
    if chunk * Q4_KSTEP > Q4_MAX_CHUNK:
        raise ValueError(f"split {s} gives a block more than "
                         f"{Q4_MAX_CHUNK} k")
    return chunk * Q4_KSTEP, -(-steps // chunk)


def quant4_split(variant, m: int, n: int, k: int):
    """(k_chunk, split) of a K14 call: :func:`quant4_plan`'s, or
    ``variant`` ``"split{s}"`` forced; None for ``"simt"`` (the three-launch
    form, any K). Raises ValueError on an unknown variant or a shape the
    cluster kernel does not take."""
    if variant == "simt":
        return None
    plan = quant4_plan(m, n, k)
    if variant is None:
        return plan
    if not variant.startswith("split"):
        raise _unknown(variant, "")
    return _forced_split(variant, variant[5:], k)


def quant8_split(variant, m: int, n: int, k: int):
    """(k_chunk, split, bn) of a K5 call: :func:`quant8_plan`'s, or with
    ``variant`` ``"split{s}"`` the split forced, ``"bn64"`` / ``"bn128"``
    the columns a block forced (the plan's split at them), or
    ``"bn{B}_split{s}"`` both; None for ``"simt"`` (the three-launch form,
    any K). Raises ValueError on an unknown variant or a shape the cluster
    kernel does not take."""
    if variant == "simt":
        return None
    k_chunk, split, bn = quant8_plan(m, n, k)
    if variant is None:
        return k_chunk, split, bn
    forms = ", 'bn64', 'bn128' or 'bn{B}_split{s}'"
    rest = variant
    if rest.startswith("bn"):
        head, sep, rest = rest[2:].partition("_")
        if not head.isdigit() or int(head) not in Q8_BNS \
                or (sep and not rest):
            raise _unknown(variant, forms)
        bn = int(head)
        if not sep:
            return (*_cluster_split(m, n, k, bn, Q8_BLOCKS_PER_SM), bn)
    if not rest.startswith("split"):
        raise _unknown(variant, forms)
    return (*_forced_split(variant, rest[5:], k), bn)


def _check_q(op, x, w, packed_shape, s_col, b, act):
    """The shape rules K5 and K14 share, for CUDA tensors; (m, k, n)."""
    partial = act == "partial"
    _build.require(x, "x", torch.bfloat16, 2)
    _build.require(s_col, "s_col", torch.float32, 1)
    if not (partial and b is None):
        _build.require(b, "b", torch.float32, 1)
    m, k = x.shape
    n = w.shape[1]
    if w.shape != packed_shape(k, n) or s_col.shape[0] != n \
            or (b is not None and b.shape[0] != n):
        raise ValueError(f"shape mismatch x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} s{tuple(s_col.shape)} "
                         f"b{None if b is None else tuple(b.shape)}")
    if not quant_takes(k, n):
        raise ValueError(f"{op.name} needs K % {_KSTAGE} == 0 and "
                         f"N % {_BN} == 0, got K={k}, N={n}")
    if not (x.device == w.device == s_col.device
            and (b is None or b.device == x.device)):
        raise ValueError("x, w, s_col and b must be on one device")
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    return m, k, n


def _out(x, m, n, act):
    return torch.empty((m, n), dtype=torch.float32 if act == "partial"
                       else torch.bfloat16, device=x.device)


def _launch_simt(op, entry, x, w, m, k, n, s_col, b, act):
    """Scratch and the three launches of the form K5 and K14 replaced
    (``entry`` is the C function), counted as ``"simt"``."""
    k_chunk, splits = split_plan(m, n, k)
    out = _out(x, m, n, act)
    # one scratch allocation (each costs the host microseconds): the int8
    # rows (M, K), their fp32 scales (M,), the int32 split-K partials
    rs_at = -(-m * k // 16) * 16
    part_at = rs_at + -(-4 * m // 16) * 16
    scratch = torch.empty(part_at + (4 * splits * m * n if splits > 1 else 0),
                          dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    fn = _build.bind("quant_linear", entry,
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), w.data_ptr(), s_col.data_ptr(),
            None if b is None else b.data_ptr(),
            out.data_ptr(), base, base + rs_at,
            base + part_at if splits > 1 else 0, m, n, k, k_chunk, splits,
            ACTS[act], _build.stream_ptr())
    op.launched("simt")
    # the row quantizer runs first; split-K adds the reduce + epilogue
    op.extra_launches += 1 + (splits > 1)
    _build.check(rc, op.name)
    return out


def _launch_cluster(op, entry, x, w, m, k, n, s_col, b, act, k_chunk, split,
                    extra=(), key=""):
    """The one launch of the cluster kernel (``entry``; ``extra`` int
    arguments after the split), counted as ``key + "split{s}"``."""
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{op.name} needs x and the weights 16-byte "
                         f"aligned")
    out = _out(x, m, n, act)
    fn = _build.bind("quant_linear", entry,
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * (6 + len(extra))
                     + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), w.data_ptr(), s_col.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), m, n, k,
            k_chunk, split, *extra, ACTS[act], _build.stream_ptr())
    op.launched(f"{key}split{split}")
    _build.check(rc, op.name)
    return out


def _launch(op, x, w4, s_col, b, act="none", variant=None):
    """``variant`` (private: tests and chip_smoke.py; :func:`quant8_split`):
    ``"split{s}"`` / ``"bn{B}"`` force the cluster kernel's split / columns
    a block, ``"simt"`` the three-launch form it replaced. Partials
    (``act="partial"``) count apart, as ``"partial_split{s}"``."""
    _build.require(w4, "w4", torch.int8, 3)
    m, k, n = _check_q(op, x, w4, lambda k_, n_: (k_ // 4, n_, 4), s_col, b,
                       act)
    plan = quant8_split(variant, m, n, k)
    if plan is None:
        return _launch_simt(op, "acai_quant_linear_bias_act", x, w4, m, k, n,
                            s_col, b, act)
    k_chunk, split, bn = plan
    return _launch_cluster(op, "acai_quant_linear_bias_act_cluster", x, w4,
                           m, k, n, s_col, b, act, k_chunk, split, (bn,),
                           "partial_" if act == "partial" else "")


def _launch4(op, x, wp, s_col, b, act="none", variant=None):
    """``variant`` (private: tests and chip_smoke.py; :func:`quant4_split`):
    ``"split{s}"`` forces the cluster kernel's split, ``"simt"`` the
    three-launch form it replaced."""
    _build.require(wp, "wp", torch.int32, 2)
    m, k, n = _check_q(op, x, wp, lambda k_, n_: (k_ // 8, n_), s_col, b,
                       act)
    plan = quant4_split(variant, m, n, k)
    if plan is None:
        return _launch_simt(op, "acai_quant4_linear_bias_act", x, wp, m, k, n,
                            s_col, b, act)
    return _launch_cluster(op, "acai_quant4_linear_bias_act_cluster", x, wp,
                           m, k, n, s_col, b, act, *plan)


quant_linear_bias_act = _build.KernelOp(
    "quant_linear_bias_act", "acai_omr_tpu_torch/csrc/quant_linear.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:619 (_qdot, the six mat sites of "
    "_kernel :1352-1356)",
    _launch, quant_linear_bias_act_plain)


quant4_linear_bias_act = _build.KernelOp(
    "quant4_linear_bias_act", "acai_omr_tpu_torch/csrc/quant_linear.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:649 (unpack_int4) and :1302-1351 "
    "(the W4A8 branch of _kernel: per-layer unpack, then _qdot), with "
    "prepack(quantize_weights='int4') :516-547",
    _launch4, quant4_linear_bias_act_plain)
