"""K8 ``layernorm_bwd``: backward of ``LayerNorm(z) * gamma + beta`` from the
saved pre-norm sum ``z``.

CUDA source: ``csrc/layernorm_bwd.cu`` (bound, design and the TPU code it
replaces are noted there). Serves the two or three post-norm LayerNorms of
every layer in the backward of the training stacks, together with the
dropout that follows each in the backward sweep.

One launch a call, counted as ``"one_pass"``: g and z read once, the column
sums kept in registers across a block's rows, the blocks' partials summed in
a fixed order behind integer tickets (:func:`layernorm_bwd_plan`).
``variant="three_pass"`` (private: tests and chip_smoke.py) forces the
three-launch form it replaced, kept as the yardstick.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import dropout_kernel as dk
from .linear_kernel import N_SMS

_SLAB = 256
# the one-pass kernel: warps a block (a row a warp at a time); blocks an SM
# its registers allow at widths up to LNB_WIDE_E (csrc/layernorm_bwd.cu
# Cols::MIN_BLOCKS) and past it; the tickets it keeps (one a group of blocks
# and the final one, zero between launches)
LNB_WARPS = 8
LNB_WIDE_E = 512
LNB_TICKETS = 64
_TICKETS: dict[torch.device, torch.Tensor] = {}
VARIANTS = (None, "three_pass")


def layernorm_bwd_plain(g: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor,
                        eps: float, drop: dk.DropSpec | None = None):
    """Plain twin -> (dz, dz_drop, dgamma, dbeta).

    Statistics in fp32 from z; ``dz`` rounded to z's dtype; ``dz_drop`` is dz
    under K10's mask (``dz`` itself when ``drop`` is None); ``dgamma`` and
    ``dbeta`` are fp32 column sums over all rows.
    """
    z32, g32 = z.float(), g.float()
    mean = z32.mean(dim=-1, keepdim=True)
    var = (z32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    zh = (z32 - mean) * inv
    gg = g32 * gamma.float()
    dz = (inv * (gg - gg.mean(dim=-1, keepdim=True)
                 - zh * (gg * zh).mean(dim=-1, keepdim=True))).to(z.dtype)
    return dz, dk.dropout_plain(dz, drop), (g32 * zh).sum(dim=0), g32.sum(dim=0)


def layernorm_bwd_plan(rows: int, e: int) -> tuple[int, int]:
    """(blocks, group) of K8's one-pass kernel for ``rows`` rows of width
    ``e``: LNB_WARPS rows a block at least, at most the blocks the SMs hold
    at once (two an SM up to LNB_WIDE_E columns, one past it), so every
    block runs in the first wave; the blocks' partials summed in groups of
    ``group`` = ceil(sqrt(blocks)) consecutive blocks, then the groups' sums,
    so no block sums more than about sqrt(blocks) partials."""
    if rows < 1:
        raise ValueError(f"layernorm_bwd needs at least one row, got {rows}")
    per_sm = 2 if e <= LNB_WIDE_E else 1
    blocks = max(1, min(-(-rows // LNB_WARPS), per_sm * N_SMS))
    return blocks, math.isqrt(blocks - 1) + 1


def _check(g, z, gamma, eps, drop=None, variant=None):
    """K8's variant, on either device (the twin takes any shape)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: None (the one-pass "
                         f"kernel) or 'three_pass'")


def _tickets(device: torch.device) -> torch.Tensor:
    """The one-pass kernel's tickets on ``device``: zero, and zero again
    after every launch (the kernel resets what it drew)."""
    t = _TICKETS.get(device)
    if t is None:
        t = _TICKETS.setdefault(device, torch.zeros(LNB_TICKETS,
                                                    dtype=torch.int32,
                                                    device=device))
    return t


def _launch(op, g, z, gamma, eps, drop=None, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"three_pass"``
    forces the three-launch form the one-pass kernel replaced."""
    _check(g, z, gamma, eps, drop, variant)
    _build.require(g, "g", torch.bfloat16, 2)
    _build.require(z, "z", torch.bfloat16, 2)
    _build.require(gamma, "gamma", torch.float32, 1)
    rows, e = z.shape
    if g.shape != z.shape or gamma.shape[0] != e:
        raise ValueError("layernorm_bwd shape mismatch")
    if e % 128 or e > 1024:
        raise ValueError(f"layernorm_bwd needs E % 128 == 0 and E <= 1024, "
                         f"got {e}")
    dropping = drop is not None and drop.rate > 0.0
    f32 = dict(dtype=torch.float32, device=z.device)
    dz = torch.empty_like(z)
    dz_drop = torch.empty_like(z) if dropping else None
    dgamma, dbeta = torch.empty(e, **f32), torch.empty(e, **f32)
    ptrs = (g.data_ptr(), z.data_ptr(), gamma.data_ptr(), dz.data_ptr(),
            None if dz_drop is None else dz_drop.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr())
    if variant == "three_pass":
        stats = torch.empty((rows, 2), **f32)
        partial = torch.empty((-(-rows // _SLAB), 2, e), **f32)
        fn = _build.bind("layernorm_bwd", "acai_layernorm_bwd",
                         [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                         + [ctypes.c_float] + dk.C_ARGTYPES
                         + [ctypes.c_void_p])
        rc = fn(*ptrs, stats.data_ptr(), partial.data_ptr(), rows, e,
                float(eps), *dk.c_args(drop), _build.stream_ptr())
        op.launched("three_pass")
        op.extra_launches += 2  # the column slabs and their sum
    else:
        blocks, group = layernorm_bwd_plan(rows, e)
        # the blocks' partials, then the groups' sums
        partial = torch.empty((blocks + -(-blocks // group), 2, e), **f32)
        fn = _build.bind("layernorm_bwd", "acai_layernorm_bwd_one_pass",
                         [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                         + [ctypes.c_float] + dk.C_ARGTYPES
                         + [ctypes.c_void_p])
        rc = fn(*ptrs, partial.data_ptr(), partial[blocks].data_ptr(),
                _tickets(z.device).data_ptr(), rows, e, blocks, group,
                float(eps), *dk.c_args(drop), _build.stream_ptr())
        op.launched("one_pass")
    _build.check(rc, op.name)
    return dz, (dz_drop if dropping else dz), dgamma, dbeta


layernorm_bwd = _build.KernelOp(
    "layernorm_bwd", "acai_omr_tpu_torch/csrc/layernorm_bwd.cu",
    "acai_omr_tpu/ops/pallas_train_layer.py:241 (_ln_bwd; _bwd_kernel :744, "
    ":802, :868)",
    _launch, layernorm_bwd_plain, _check)
