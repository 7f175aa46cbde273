"""K9 ``linear_bwd``: the backward products of ``y = x @ w + b``.

CUDA source: ``csrc/linear_bwd.cu`` (bound, design and the TPU code it
replaces are noted there). Two ops: :data:`linear_dgrad` (``dX = dY W^T`` with
the backward sweep's elementwise epilogues) and :data:`linear_wgrad`
(``dW = X^T dY`` summed in fp32 over all rows, ``db = colsum(dY)``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import dropout_kernel as dk

_BM, _BN, _BK = 64, 64, 32
_SLAB = 256
_TARGET_BLOCKS = 2 * 132  # two waves of blocks on an H100's 132 SMs


def linear_dgrad_plain(dy: torch.Tensor, w: torch.Tensor,
                       drop: dk.DropSpec | None = None,
                       mul: torch.Tensor | None = None,
                       add: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin: round(dy @ w^T); then K10's mask; then ``* mul`` rounded
    (``du = round(dh1 * gelu')``); then ``add + .`` in dy's dtype."""
    out = torch.matmul(dy.float(), w.float().t()).to(dy.dtype)
    out = dk.dropout_plain(out, drop)
    if mul is not None:
        out = (out.float() * mul.float()).to(dy.dtype)
    if add is not None:
        out = add + out
    return out


def _launch_dgrad(op, dy, w, drop=None, mul=None, add=None):
    _build.require(dy, "dy", torch.bfloat16, 2)
    _build.require(w, "w", torch.bfloat16, 2)
    m, n = dy.shape
    k = w.shape[0]
    if w.shape[1] != n:
        raise ValueError(f"shape mismatch dy{tuple(dy.shape)} "
                         f"w{tuple(w.shape)}")
    if n % _BK or k % _BN:
        raise ValueError(f"linear_dgrad needs N % {_BK} == 0 and "
                         f"K % {_BN} == 0, got N={n}, K={k}")
    for name, t in (("mul", mul), ("add", add)):
        if t is not None:
            _build.require(t, name, torch.bfloat16, 2)
            if t.shape != (m, k):
                raise ValueError(f"{name} must be {(m, k)}")
    out = torch.empty((m, k), dtype=torch.bfloat16, device=dy.device)
    fn = _build.bind("linear_bwd", "acai_linear_dgrad",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                     + dk.C_ARGTYPES + [ctypes.c_void_p])
    rc = fn(dy.data_ptr(), w.data_ptr(),
            None if mul is None else mul.data_ptr(),
            None if add is None else add.data_ptr(), out.data_ptr(), m, n, k,
            *dk.c_args(drop), _build.stream_ptr())
    op.launches += 1
    _build.check(rc, op.name)
    return out


linear_dgrad = _build.KernelOp(
    "linear_dgrad", "acai_omr_tpu_torch/csrc/linear_bwd.cu",
    "acai_omr_tpu/ops/pallas_train_layer.py:784 (_dot_bt in _bwd_kernel "
    ":784, :788, :810, :861, :878, :949; du :786)",
    _launch_dgrad, linear_dgrad_plain)


def linear_wgrad_plain(x: torch.Tensor, dy: torch.Tensor):
    """Plain twin -> (dW (K, N) in x's dtype, db (N,) fp32): fp32 sums over
    all rows, dW rounded once."""
    dw = torch.matmul(x.float().t(), dy.float()).to(x.dtype)
    return dw, dy.float().sum(dim=0)


def row_split_plan(r: int, k: int, n: int) -> tuple[int, int]:
    """(r_chunk, splits): split the contracted rows across blocks when the
    output tiles alone are too few to fill the card."""
    tiles = (k // _BM) * (n // _BN)
    r_tiles = r // _BK
    splits = max(1, min(r_tiles, _TARGET_BLOCKS // max(tiles, 1)))
    chunk = -(-r_tiles // splits)
    splits = -(-r_tiles // chunk)
    return chunk * _BK, splits


def _launch_wgrad(op, x, dy, out=None, out_bias=None):
    """``out`` / ``out_bias``: contiguous destinations (a layer's slice of
    the stacked gradient), allocated when None."""
    _build.require(x, "x", torch.bfloat16, 2)
    _build.require(dy, "dy", torch.bfloat16, 2)
    r, k = x.shape
    n = dy.shape[1]
    if dy.shape[0] != r:
        raise ValueError(f"shape mismatch x{tuple(x.shape)} "
                         f"dy{tuple(dy.shape)}")
    if r % _BK or k % _BM or n % _BN:
        raise ValueError(f"linear_wgrad needs rows % {_BK} == 0, "
                         f"K % {_BM} == 0 and N % {_BN} == 0, got "
                         f"rows={r}, K={k}, N={n}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dw = torch.empty((k, n), dtype=torch.bfloat16, device=x.device) \
        if out is None else out
    db = torch.empty(n, **f32) if out_bias is None else out_bias
    _build.require(dw, "out", torch.bfloat16, 2)
    _build.require(db, "out_bias", torch.float32, 1)
    if dw.shape != (k, n) or db.shape != (n,):
        raise ValueError("linear_wgrad destination shape mismatch")
    r_chunk, splits = row_split_plan(r, k, n)
    part = torch.empty((splits, k, n), **f32) if splits > 1 else None
    db_part = torch.empty((-(-r // _SLAB), n), **f32)
    fn = _build.bind("linear_bwd", "acai_linear_wgrad",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), db.data_ptr(),
            None if part is None else part.data_ptr(), db_part.data_ptr(),
            r, k, n, r_chunk, splits, _build.stream_ptr())
    op.launched(f"splits{splits}")
    op.extra_launches += 2 + (part is not None)  # bias slabs, sum, reduce
    _build.check(rc, op.name)
    return dw, db


def _wgrad_plain_into(x, dy, out=None, out_bias=None):
    dw, db = linear_wgrad_plain(x, dy)
    if out is not None:
        dw = out.copy_(dw)
    if out_bias is not None:
        db = out_bias.copy_(db)
    return dw, db


linear_wgrad = _build.KernelOp(
    "linear_wgrad", "acai_omr_tpu_torch/csrc/linear_bwd.cu",
    "acai_omr_tpu/ops/pallas_train_layer.py:666 (_acc / _dot_tb in "
    "_bwd_kernel :782, :789, :860, :862, :948, :950; bias sums :766-951)",
    _launch_wgrad, _wgrad_plain_into)
