"""K4 ``add_layernorm``: LayerNorm(x + r) with the residual sum rounded to the
compute dtype and fp32 statistics.

CUDA source: ``csrc/add_layernorm.cu`` (bound, design and the TPU kernel it
replaces are noted there). Serves every post-norm residual LayerNorm inside
the two ported stacks.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


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


def _launch(op, x, r, gamma, beta, eps, return_sum=False):
    _build.require(x, "x", torch.bfloat16, 2)
    if r is not None:
        _build.require(r, "r", torch.bfloat16, 2)
    _build.require(gamma, "gamma", torch.float32, 1)
    _build.require(beta, "beta", torch.float32, 1)
    rows, e = x.shape
    if (r is not None and r.shape != x.shape) or gamma.shape[0] != e \
            or beta.shape[0] != e:
        raise ValueError("add_layernorm shape mismatch")
    if return_sum and r is None:
        raise ValueError("return_sum needs the second operand")
    if e % 32 or e > 1024:
        raise ValueError(f"add_layernorm needs E % 32 == 0 and E <= 1024, "
                         f"got {e}")
    out = torch.empty_like(x)
    z = torch.empty_like(x) if return_sum else None
    fn = _build.bind("add_layernorm", "acai_add_layernorm",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                     + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(x.data_ptr(), None if r is None else r.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            None if z is None else z.data_ptr(), rows, e, float(eps),
            _build.stream_ptr())
    op.launches += 1
    _build.check(rc, op.name)
    return (out, z) if return_sum else out


add_layernorm = _build.KernelOp(
    "add_layernorm", "acai_omr_tpu_torch/csrc/add_layernorm.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:716 (_ln) and "
    "acai_omr_tpu/ops/pallas_train_layer.py:231 (_ln_fwd)",
    _launch, add_layernorm_plain)
