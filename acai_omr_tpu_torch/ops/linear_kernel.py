"""K1 ``linear_bias_act``: act(x @ w + b) with an fp32 accumulator.

CUDA source: ``csrc/linear_bias_act.cu`` (bound, design and the TPU kernel it
replaces are noted there). Serves every product inside the two ported stacks:
the skinny decode rows (M = B) and the encoder rows (M = B*T).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import dropout_kernel as dk

ACTS = {"none": 0, "gelu": 1, "gelu_rounded": 2, "partial": 3}
_BM, _BN, _BK = 64, 64, 32
_TARGET_BLOCKS = 2 * 132  # two waves of blocks on an H100's 132 SMs


def _gelu32(u: torch.Tensor) -> torch.Tensor:
    return 0.5 * u * (1.0 + torch.erf(u / math.sqrt(2.0)))


def gelu_grad32(u: torch.Tensor) -> torch.Tensor:
    """d GELU(u) / du = 0.5 (1 + erf(u / sqrt 2)) + u phi(u), fp32."""
    phi = torch.exp(-0.5 * u * u) * (1.0 / math.sqrt(2.0 * math.pi))
    return 0.5 * (1.0 + torch.erf(u / math.sqrt(2.0))) + u * phi


def linear_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          act: str = "none", drop: dk.DropSpec | None = None,
                          save_gelu_grad: bool = False):
    """Plain twin: fp32 product and bias, the activation, then x's dtype.

    ``gelu`` applies exact GELU to the fp32 sum (the encoder kernel);
    ``gelu_rounded`` rounds the sum to x's dtype first (the decode monolith).
    ``drop`` applies K10's mask to the rounded output. ``save_gelu_grad``
    (with ``gelu``) also returns GELU'(u) of the same fp32 sum, rounded: the
    pair (h1, gelu') the training forward saves. ``partial`` returns the bare
    fp32 product, without the bias (``b`` may be None): a rank's share of a
    tensor-parallel row-parallel product, summed by K15 ``tp_allreduce``.
    """
    if act == "partial":
        return torch.matmul(x.float(), w.float())
    u = torch.matmul(x.float(), w.float()) + b.float()
    gp = None
    if act == "gelu":
        if save_gelu_grad:
            gp = gelu_grad32(u).to(x.dtype)
        u = _gelu32(u)
    elif act == "gelu_rounded":
        u = _gelu32(u.to(x.dtype).float())
    elif act != "none":
        raise ValueError(f"unknown activation {act!r}")
    if save_gelu_grad and gp is None:
        raise ValueError("save_gelu_grad needs act='gelu'")
    out = dk.dropout_plain(u.to(x.dtype), drop)
    return (out, gp) if save_gelu_grad else out


def split_plan(m: int, n: int, k: int) -> tuple[int, int]:
    """(k_chunk, splits): split K across blocks when the output tiles alone
    are too few to keep the card's SMs streaming the weights."""
    tiles = (n // _BN) * (-(-m // _BM))
    k_tiles = k // _BK
    splits = max(1, min(k_tiles, _TARGET_BLOCKS // max(tiles, 1)))
    chunk = -(-k_tiles // splits)
    splits = -(-k_tiles // chunk)
    return chunk * _BK, splits


def _launch(op, x, w, b, act="none", drop=None, save_gelu_grad=False):
    partial = act == "partial"
    _build.require(x, "x", torch.bfloat16, 2)
    _build.require(w, "w", torch.bfloat16, 2)
    if not (partial and b is None):
        _build.require(b, "b", torch.float32, 1)
    m, k = x.shape
    n = w.shape[1]
    if w.shape[0] != k or (b is not None and b.shape[0] != n):
        raise ValueError(f"shape mismatch x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"b{None if b is None else tuple(b.shape)}")
    if k % _BK or n % _BN:
        raise ValueError(f"linear_bias_act needs K % {_BK} == 0 and "
                         f"N % {_BN} == 0, got K={k}, N={n}")
    if x.device != w.device or (b is not None and x.device != b.device):
        raise ValueError("x, w and b must be on one device")
    if save_gelu_grad and act != "gelu":
        raise ValueError("save_gelu_grad needs act='gelu'")
    if partial and drop is not None:
        raise ValueError("the partial product takes no dropout")
    k_chunk, splits = split_plan(m, n, k)
    out = torch.empty((m, n), dtype=torch.float32 if partial
                      else torch.bfloat16, device=x.device)
    gp = torch.empty_like(out) if save_gelu_grad else None
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    fn = _build.bind("linear_bias_act", "acai_linear_bias_act",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                     + dk.C_ARGTYPES + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(),
            None if gp is None else gp.data_ptr(),
            None if part is None else part.data_ptr(), m, n, k, k_chunk,
            splits, ACTS[act], *dk.c_args(drop), _build.stream_ptr())
    if partial:  # counted apart too: the tensor-parallel step's partials
        op.launched("partial")
    else:
        op.launches += 1
    op.extra_launches += part is not None  # the split-K reduce kernel
    _build.check(rc, op.name)
    return (out, gp) if save_gelu_grad else out


linear_bias_act = _build.KernelOp(
    "linear_bias_act", "acai_omr_tpu_torch/csrc/linear_bias_act.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:1358 (_kernel mat dots) and "
    "acai_omr_tpu/ops/pallas_train_layer.py:472 (_fwd_kernel dots)",
    _launch, linear_bias_act_plain)
