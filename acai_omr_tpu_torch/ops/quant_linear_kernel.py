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
replace are noted there). The weights are held K-packed so that one 32-bit
load feeds ``__dp4a`` directly; the plain twins read the same tensors.

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
from .linear_kernel import ACTS, _gelu32

INT8_QMAX = 127.0
INT4_QMAX = 7.0
_BN, _KSTAGE, _BM = 128, 128, 32
_TARGET_BLOCKS = 2 * 132  # two waves of blocks on an H100's 132 SMs


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
    """(k_chunk, splits): K is split across blocks until about two waves of
    blocks stream the weights. int32 partial sums add up exactly in any
    order."""
    tiles = (n // _BN) * (-(-m // _BM))
    k_tiles = k // _KSTAGE
    splits = max(1, min(k_tiles, _TARGET_BLOCKS // max(tiles, 1)))
    chunk = -(-k_tiles // splits)
    return chunk * _KSTAGE, -(-k_tiles // chunk)


def _launch_q(op, entry, x, w, packed_shape, s_col, b, act):
    """Checks, scratch and launch shared by K5 and K14 (``entry`` is the C
    function; ``packed_shape(k, n)`` the weight tensor's shape)."""
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
    if k % _KSTAGE or n % _BN:
        raise ValueError(f"{op.name} needs K % {_KSTAGE} == 0 and "
                         f"N % {_BN} == 0, got K={k}, N={n}")
    if not (x.device == w.device == s_col.device
            and (b is None or b.device == x.device)):
        raise ValueError("x, w, s_col and b must be on one device")
    k_chunk, splits = split_plan(m, n, k)
    out = torch.empty((m, n), dtype=torch.float32 if partial
                      else torch.bfloat16, device=x.device)
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
    if partial:  # counted apart too: the tensor-parallel step's partials
        op.launched("partial")
    else:
        op.launches += 1
    # the row quantizer runs first; split-K adds the reduce + epilogue
    op.extra_launches += 1 + (splits > 1)
    _build.check(rc, op.name)
    return out


def _launch(op, x, w4, s_col, b, act="none"):
    _build.require(w4, "w4", torch.int8, 3)
    return _launch_q(op, "acai_quant_linear_bias_act", x, w4,
                     lambda k, n: (k // 4, n, 4), s_col, b, act)


def _launch4(op, x, wp, s_col, b, act="none"):
    _build.require(wp, "wp", torch.int32, 2)
    return _launch_q(op, "acai_quant4_linear_bias_act", x, wp,
                     lambda k, n: (k // 8, n), s_col, b, act)


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
