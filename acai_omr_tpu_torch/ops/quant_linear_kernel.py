"""K5 ``quant_linear_bias_act``: the W8A8 product of the int8 decode step.

act(((int8(x) @ w8) * row_scale) * col_scale + b): each activation row is
quantized over its whole contraction axis (max-abs, fp32 scale, round half to
even), multiplied with the int8 weights in exact int32 arithmetic, and
dequantized by the row scale, then by the weights' per-output-column scale.

CUDA source: ``csrc/quant_linear.cu`` (bound, design and the TPU kernel it
replaces are noted there). The int8 weights are held K-packed four at a time,
``(IN/4, OUT, 4)``, so that one 32-bit load feeds one ``__dp4a``
(:func:`pack_k4` / :func:`unpack_k4`); the plain twin reads the same tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .linear_kernel import ACTS, _gelu32

INT8_QMAX = 127.0
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


def quantize_activation_rows(x: torch.Tensor):
    """(M, K) -> (int-valued fp32 (M, K), fp32 row scale (M, 1)): max-abs over
    the whole row, scale not rounded, no clip (|x| / scale <= 127 already)."""
    x32 = x.float()
    rs = x32.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / INT8_QMAX
    return torch.round(x32 / rs), rs


def quant_linear_bias_act_plain(x: torch.Tensor, w4: torch.Tensor,
                                s_col: torch.Tensor, b: torch.Tensor,
                                act: str = "none") -> torch.Tensor:
    """Plain twin. x (M, K) compute dtype; w4 (K/4, N, 4) int8; s_col, b (N,)
    fp32. The integer product runs in float64, where it is exact."""
    x8, rs = quantize_activation_rows(x)
    acc = torch.matmul(x8.double(), unpack_k4(w4).double()).float()
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


def _launch(op, x, w4, s_col, b, act="none"):
    _build.require(x, "x", torch.bfloat16, 2)
    _build.require(w4, "w4", torch.int8, 3)
    _build.require(s_col, "s_col", torch.float32, 1)
    _build.require(b, "b", torch.float32, 1)
    m, k = x.shape
    n = w4.shape[1]
    if w4.shape != (k // 4, n, 4) or s_col.shape[0] != n or b.shape[0] != n:
        raise ValueError(f"shape mismatch x{tuple(x.shape)} "
                         f"w4{tuple(w4.shape)} s{tuple(s_col.shape)} "
                         f"b{tuple(b.shape)}")
    if k % _KSTAGE or n % _BN:
        raise ValueError(f"quant_linear_bias_act needs K % {_KSTAGE} == 0 and "
                         f"N % {_BN} == 0, got K={k}, N={n}")
    if not (x.device == w4.device == s_col.device == b.device):
        raise ValueError("x, w4, s_col and b must be on one device")
    k_chunk, splits = split_plan(m, n, k)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    # one scratch allocation (each costs the host microseconds): the int8
    # rows (M, K), their fp32 scales (M,), the int32 split-K partials
    rs_at = -(-m * k // 16) * 16
    part_at = rs_at + -(-4 * m // 16) * 16
    scratch = torch.empty(part_at + (4 * splits * m * n if splits > 1 else 0),
                          dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    fn = _build.bind("quant_linear", "acai_quant_linear_bias_act",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), w4.data_ptr(), s_col.data_ptr(), b.data_ptr(),
            out.data_ptr(), base, base + rs_at,
            base + part_at if splits > 1 else 0, m, n, k, k_chunk, splits,
            ACTS[act], _build.stream_ptr())
    op.launches += 1
    # the row quantizer runs first; split-K adds the reduce + epilogue
    op.extra_launches += 1 + (splits > 1)
    _build.check(rc, op.name)
    return out


quant_linear_bias_act = _build.KernelOp(
    "quant_linear_bias_act", "acai_omr_tpu_torch/csrc/quant_linear.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:619 (_qdot, the six mat sites of "
    "_kernel :1352-1356)",
    _launch, quant_linear_bias_act_plain)
