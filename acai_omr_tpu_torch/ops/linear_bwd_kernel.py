"""K9 ``linear_bwd``: the backward products of ``y = x @ w + b``.

CUDA source: ``csrc/linear_bwd.cu`` (bound, design and the TPU code it
replaces are noted there). Two ops, both on the Hopper GEMM core
``csrc/sm90_gemm.cuh``: :data:`linear_dgrad` (``dX = dY W^T`` with the
backward sweep's elementwise epilogues, its tile from :func:`dgrad_plan`;
``KernelOp.variants``: ``"sm90"``) and :data:`linear_wgrad` (``dW = X^T dY``
summed in fp32 over all rows, ``db = colsum(dY)``, its rows split by
:func:`row_split_plan`; ``"sm90_splits{s}"``). The pre-Hopper wmma kernels
stay as their yardsticks (``variant="wmma"``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import dropout_kernel as dk
from .linear_kernel import SM90_BM, SM90_BNS, N_SMS, core_s, sm90_tile_n

_BM, _BN, _BK = 64, 64, 32
_SLAB = 256
_CORE_BK = 64  # the core's K step: a row split is a multiple of it
_MAX_SPLITS = 32
_BYTES_S = 3.35e12  # device memory, for the fp32 partials (H100 SXM)


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


def dgrad_plan(m: int, k: int, n: int) -> tuple[str, int]:
    """(variant, BN) of dX (M, K) = dY (M, N) W^T: the Hopper core
    (``"sm90"``), a 128 x BN tile of dX a block over the whole contraction,
    BN as :func:`.linear_kernel.sm90_tile_n` picks it for this product (the
    core's time model). The contraction is not split: every dgrad of the
    port's paths has at least 64 tiles at that BN, and a split would have to
    run the epilogue (rounding, K10's mask, ``* mul``, ``+ add``) after an
    fp32 reduce."""
    return "sm90", sm90_tile_n(m, k, n)


def check_dgrad_shape(variant: str, k: int, n: int) -> None:
    """Raise on an (N -> K) product the kernel of ``variant`` does not take:
    the core's rule is TMA's (16-byte row strides), the wmma kernel's its
    tiles'."""
    if variant == "wmma" and (n % _BK or k % _BN):
        raise ValueError(f"linear_dgrad's wmma kernel needs N % {_BK} == 0 "
                         f"and K % {_BN} == 0, got N={n}, K={k}")
    if k % 8 or n % 8:
        raise ValueError(f"linear_dgrad needs K % 8 == 0 and N % 8 == 0 "
                         f"(TMA's 16-byte row strides), got N={n}, K={k}")


def _launch_dgrad(op, dy, w, drop=None, mul=None, add=None, *,
                  variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"wmma"`` for the
    pre-Hopper kernel in place of :func:`dgrad_plan`'s core."""
    _build.require(dy, "dy", torch.bfloat16, 2)
    _build.require(w, "w", torch.bfloat16, 2)
    m, n = dy.shape
    k = w.shape[0]
    if w.shape[1] != n:
        raise ValueError(f"shape mismatch dy{tuple(dy.shape)} "
                         f"w{tuple(w.shape)}")
    plan, bn = dgrad_plan(m, k, n)
    if variant is not None:
        if variant not in ("sm90", "wmma"):
            raise ValueError(f"unknown variant {variant!r}")
        plan = variant
    check_dgrad_shape(plan, k, n)
    if plan == "wmma":
        bn = _BN
    elif dy.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("linear_dgrad needs dy and w 16-byte aligned")
    for name, t in (("mul", mul), ("add", add)):
        if t is not None:
            _build.require(t, name, torch.bfloat16, 2)
            if t.shape != (m, k):
                raise ValueError(f"{name} must be {(m, k)}")
    out = torch.empty((m, k), dtype=torch.bfloat16, device=dy.device)
    fn = _build.bind("linear_bwd", "acai_linear_dgrad",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                     + dk.C_ARGTYPES + [ctypes.c_void_p])
    rc = fn(dy.data_ptr(), w.data_ptr(),
            None if mul is None else mul.data_ptr(),
            None if add is None else add.data_ptr(), out.data_ptr(), m, n, k,
            bn, *dk.c_args(drop), _build.stream_ptr())
    op.launched(plan)
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


def row_split_plan(r: int, k: int, n: int) -> tuple[int, int, int]:
    """(r_chunk, splits, bn): how the core computes dW (K, N) = X^T dY over R
    rows. The output has ceil(K / 128) x ceil(N / bn) tiles; ``splits``
    ranges of ``r_chunk`` rows (a multiple of 64) each take one block per
    tile. The plan minimises the core's modelled time
    (``linear_kernel.core_s``: waves of tiles x splits blocks on the card's
    132 SMs, each a fixed cost plus its k-steps) plus the fp32 partials'
    traffic (splits x K x N x 4 bytes written and read again at 3.35 TB/s)
    when the rows are split; ties go to fewer splits, then the wider tile.
    The fixed-order reduce sums the splits and rounds once, so every plan
    gives bits that repeat from run to run. Empty SM slots are a cost the
    model weighs, not a rule: at the port's shapes (PERF.md section 6) the
    plan leaves under 55 % of its waves' slots empty, the most where the
    model finds no split faster (stage 2's 1024 x 1024 products at 2,048
    rows: 64 tiles)."""
    best = None
    for bn in SM90_BNS:
        tiles = -(-k // SM90_BM) * -(-n // bn)
        for want in range(1, _MAX_SPLITS + 1):
            r_chunk, splits = row_chunks(r, want)
            if splits != want:
                continue  # the same chunks as fewer splits
            t = core_s(tiles * splits, r_chunk // _CORE_BK, bn)
            if splits > 1:
                t += 2 * splits * k * n * 4 / _BYTES_S
            key = (t, splits, -bn)
            if best is None or key < best[0]:
                best = (key, (r_chunk, splits, bn))
    return best[1]


def wmma_row_chunks(r: int, k: int, n: int) -> tuple[int, int]:
    """(r_chunk, splits) of the wmma kernel (the core's yardstick): rows
    split while the 64 x 64 output tiles alone are fewer than two waves."""
    tiles = (k // _BM) * (n // _BN)
    r_tiles = r // _BK
    splits = max(1, min(r_tiles, 2 * N_SMS // max(tiles, 1)))
    chunk = -(-r_tiles // splits)
    return chunk * _BK, -(-r_tiles // chunk)


def row_chunks(r: int, splits: int) -> tuple[int, int]:
    """(r_chunk, splits): R rows in at most ``splits`` ranges of a multiple
    of 64 rows, every row in exactly one range."""
    steps = max(1, -(-r // _CORE_BK))
    chunk = -(-steps // splits)
    return chunk * _CORE_BK, -(-steps // chunk)


def _launch_wgrad(op, x, dy, out=None, out_bias=None, *, variant=None):
    """``out`` / ``out_bias``: contiguous destinations (a layer's slice of
    the stacked gradient), allocated when None. ``variant`` (private: tests
    and chip_smoke.py): ``(splits, bn)`` in place of :func:`row_split_plan`'s,
    or ``"wmma"`` for the pre-Hopper kernel (:func:`wmma_row_chunks`)."""
    _build.require(x, "x", torch.bfloat16, 2)
    _build.require(dy, "dy", torch.bfloat16, 2)
    r, k = x.shape
    n = dy.shape[1]
    if dy.shape[0] != r:
        raise ValueError(f"shape mismatch x{tuple(x.shape)} "
                         f"dy{tuple(dy.shape)}")
    if k % 8 or n % 8:
        raise ValueError(f"linear_wgrad needs K % 8 == 0 and N % 8 == 0 "
                         f"(TMA's 16-byte row strides), got K={k}, N={n}")
    if variant == "wmma" and (r % _BK or k % _BM or n % _BN):
        raise ValueError(f"linear_wgrad's wmma kernel needs rows % {_BK} == 0"
                         f", K % {_BM} == 0 and N % {_BN} == 0, got rows={r}, "
                         f"K={k}, N={n}")
    if x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("linear_wgrad needs x and dy 16-byte aligned")
    f32 = dict(dtype=torch.float32, device=x.device)
    dw = torch.empty((k, n), dtype=torch.bfloat16, device=x.device) \
        if out is None else out
    db = torch.empty(n, **f32) if out_bias is None else out_bias
    _build.require(dw, "out", torch.bfloat16, 2)
    _build.require(db, "out_bias", torch.float32, 1)
    if dw.shape != (k, n) or db.shape != (n,):
        raise ValueError("linear_wgrad destination shape mismatch")
    _, splits, bn = row_split_plan(r, k, n)
    if variant == "wmma":
        (r_chunk, splits), bn = wmma_row_chunks(r, k, n), _BN
    else:
        if variant is not None:
            splits, bn = variant
        r_chunk, splits = row_chunks(r, splits)
    part = torch.empty((splits, k, n), **f32) if splits > 1 else None
    db_part = torch.empty((-(-r // _SLAB), n), **f32)
    fn = _build.bind("linear_bwd", "acai_linear_wgrad",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), db.data_ptr(),
            None if part is None else part.data_ptr(), db_part.data_ptr(),
            r, k, n, r_chunk, splits, bn, _build.stream_ptr())
    op.launched(("wmma" if bn == _BN else "sm90") + f"_splits{splits}")
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
