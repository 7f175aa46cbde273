"""K4 ``add_layernorm``: LayerNorm(x + r) with the residual sum rounded to the
compute dtype and fp32 statistics.

CUDA source: ``csrc/add_layernorm.cu`` (bound, design and the TPU kernel it
replaces are noted there). Serves every post-norm residual LayerNorm inside
the two ported stacks and the decode step.

Launches are counted by variant: ``"warps{W}"``, the vector kernel with W
warps a row as :func:`add_layernorm_plan` picks it; ``"scalar"``, the first
form, taken only when a caller forces it (``variant="scalar"``, to time the
two in turns).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_E = 1024
VARIANTS = ("scalar", "warps1", "warps4")
PLAN_SPLIT_ROWS = 512  # the most rows that get four warps a row


def add_layernorm_plan(rows: int, e: int) -> str:
    """The vector kernel's warps a row for ``rows`` rows of width ``e``.

    At the decode step's rows (1-128) a row's latency is the kernel's time:
    four warps a row (one row a block) split its loads and its sums and were
    the fastest, warm and from HBM; at the encoder's and the MAE's rows
    (8,192 and more) one warp a row (four rows a block, no shared-memory
    exchange, gamma and beta read late) was (``chip_smoke.py --k4-plan`` on
    an H100). No serving path runs between; the stage-2 decoder's 2,048 rows
    take one warp, where four read about 8 % faster."""
    del e
    return "warps4" if rows <= PLAN_SPLIT_ROWS else "warps1"


def add_layernorm_plain(x: torch.Tensor, r: torch.Tensor | None,
                        gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                        return_sum: bool = False):
    """Plain twin: z = x + r in x's dtype, LayerNorm of z in fp32, x's dtype.

    ``r=None`` normalises x itself (the backward re-derives a layer's
    normalised activations from the saved sums). ``return_sum`` also returns z
    (the pre-norm residual sums the training forward saves)."""
    zr = x if r is None else x + r
    z = zr.float()
    mean = z.mean(dim=-1, keepdim=True)
    var = (z - mean).square().mean(dim=-1, keepdim=True)
    y = (z - mean) * torch.rsqrt(var + eps)
    out = (y * gamma.float() + beta.float()).to(x.dtype)
    return (out, zr) if return_sum else out


def layernorm_takes(e: int, variant: str = "warps4") -> bool:
    """K4's width rule for ``variant``'s kernel, on either device: E a
    multiple of 8 (the vector kernels' 16-byte accesses; 32 for the scalar
    kernel) and at most MAX_E."""
    return e % (32 if variant == "scalar" else 8) == 0 and 0 < e <= MAX_E


def _check(x, r, gamma, beta, eps, return_sum=False, variant=None):
    """K4's rules on either device; the variant the call takes (the plan's
    unless ``variant`` forces one)."""
    if x.dim() != 2:
        raise ValueError(f"add_layernorm takes (R, E) rows, got "
                         f"{tuple(x.shape)}")
    rows, e = x.shape
    if (r is not None and r.shape != x.shape) or gamma.shape != (e,) \
            or beta.shape != (e,):
        raise ValueError("add_layernorm shape mismatch")
    if return_sum and r is None:
        raise ValueError("return_sum needs the second operand")
    if variant is None:
        variant = add_layernorm_plan(rows, e)
    elif variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    step = 32 if variant == "scalar" else 8
    if not layernorm_takes(e, variant):
        raise ValueError(f"add_layernorm needs E % {step} == 0 and "
                         f"E <= {MAX_E}, got {e}")
    return variant


def _launch(op, x, r, gamma, beta, eps, return_sum=False, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"warps{W}"`` forces
    the vector kernel's warps a row, ``"scalar"`` the kernel it replaced."""
    variant = _check(x, r, gamma, beta, eps, return_sum, variant)
    _build.require(x, "x", torch.bfloat16, 2)
    if r is not None:
        _build.require(r, "r", torch.bfloat16, 2)
    _build.require(gamma, "gamma", torch.float32, 1)
    _build.require(beta, "beta", torch.float32, 1)
    rows, e = x.shape
    if (x.data_ptr() | (0 if r is None else r.data_ptr()) | gamma.data_ptr()
            | beta.data_ptr()) % 16:
        raise ValueError("add_layernorm needs 16-byte aligned operands")
    out = torch.empty_like(x)
    z = torch.empty_like(x) if return_sum else None
    fn = _build.bind("add_layernorm", "acai_add_layernorm",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    rc = fn(x.data_ptr(), None if r is None else r.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            None if z is None else z.data_ptr(), rows, e, float(eps),
            0 if variant == "scalar" else int(variant[5:]),
            _build.stream_ptr())
    op.launched(variant)
    _build.check(rc, op.name)
    return (out, z) if return_sum else out


add_layernorm = _build.KernelOp(
    "add_layernorm", "acai_omr_tpu_torch/csrc/add_layernorm.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:716 (_ln) and "
    "acai_omr_tpu/ops/pallas_train_layer.py:231 (_ln_fwd)",
    _launch, add_layernorm_plain, _check)
