"""K8 ``layernorm_bwd``: backward of ``LayerNorm(z) * gamma + beta`` from the
saved pre-norm sum ``z``.

CUDA source: ``csrc/layernorm_bwd.cu`` (bound, design and the TPU code it
replaces are noted there). Serves the two or three post-norm LayerNorms of
every layer in the backward of the training stacks, together with the
dropout that follows each in the backward sweep.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import dropout_kernel as dk

_SLAB = 256


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


def _launch(op, g, z, gamma, eps, drop=None):
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
    stats = torch.empty((rows, 2), **f32)
    partial = torch.empty((-(-rows // _SLAB), 2, e), **f32)
    fn = _build.bind("layernorm_bwd", "acai_layernorm_bwd",
                     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                     + [ctypes.c_float] + dk.C_ARGTYPES + [ctypes.c_void_p])
    rc = fn(g.data_ptr(), z.data_ptr(), gamma.data_ptr(), dz.data_ptr(),
            None if dz_drop is None else dz_drop.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), stats.data_ptr(),
            partial.data_ptr(), rows, e, float(eps), *dk.c_args(drop),
            _build.stream_ptr())
    op.launches += 1
    op.extra_launches += 2  # the column slabs and their sum
    _build.check(rc, op.name)
    return dz, (dz_drop if dropping else dz), dgamma, dbeta


layernorm_bwd = _build.KernelOp(
    "layernorm_bwd", "acai_omr_tpu_torch/csrc/layernorm_bwd.cu",
    "acai_omr_tpu/ops/pallas_train_layer.py:241 (_ln_bwd; _bwd_kernel :744, "
    ":802, :868)",
    _launch, layernorm_bwd_plain)
