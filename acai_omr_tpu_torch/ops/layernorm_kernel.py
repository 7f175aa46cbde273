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


def add_layernorm_plain(x: torch.Tensor, r: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain twin: z = x + r in x's dtype, LayerNorm of z in fp32, x's dtype."""
    z = (x + r).float()
    mean = z.mean(dim=-1, keepdim=True)
    var = (z - mean).square().mean(dim=-1, keepdim=True)
    y = (z - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def _launch(op, x, r, gamma, beta, eps):
    _build.require(x, "x", torch.bfloat16, 2)
    _build.require(r, "r", torch.bfloat16, 2)
    _build.require(gamma, "gamma", torch.float32, 1)
    _build.require(beta, "beta", torch.float32, 1)
    rows, e = x.shape
    if r.shape != x.shape or gamma.shape[0] != e or beta.shape[0] != e:
        raise ValueError("add_layernorm shape mismatch")
    if e % 32 or e > 1024:
        raise ValueError(f"add_layernorm needs E % 32 == 0 and E <= 1024, "
                         f"got {e}")
    out = torch.empty_like(x)
    fn = _build.bind("add_layernorm", "acai_add_layernorm",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                     + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(x.data_ptr(), r.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), rows, e, float(eps), _build.stream_ptr())
    op.launches += 1
    _build.check(rc, op.name)
    return out


add_layernorm = _build.KernelOp(
    "add_layernorm", "acai_omr_tpu_torch/csrc/add_layernorm.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:716 (_ln) and "
    "acai_omr_tpu/ops/pallas_train_layer.py:231 (_ln_fwd)",
    _launch, add_layernorm_plain)
