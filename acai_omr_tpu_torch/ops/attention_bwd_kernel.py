"""K7 ``attention_bwd``: backward of one attention site of the training
stacks.

CUDA source: ``csrc/attention_bwd.cu`` (bound, design and the TPU code it
replaces are noted there). Operands are the (B, T, E) views
:func:`.encoder_stack_kernel.split_qkv` gives; the three gradients are written
through destination views, so the self site fills one ``(B*T, 3E)`` buffer
and the cross site fills ``dqc`` and the layer's slice of ``d(mem_kv)``. The
attention output itself is not returned: the backward of the stacks
recomputes it with K3, which gives the forward's bits.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .encoder_stack_kernel import attention_probs, check_attention_operands


def attention_bwd_plain(q, k, v, d_o, valid, num_heads: int, causal: bool,
                        dq=None, dk=None, dv=None):
    """Plain twin -> (dq (B, Tq, E), dk, dv (B, Tk, E)).

    The probabilities are recomputed as the forward computes them; then
    dP = dO V^T, dV = round(P)^T dO, dS = P * (dP - rowsum(dP * P)) scaled by
    1/sqrt(Dh) and rounded, dQ = dS K, dK = dS^T Q, each rounded once. When
    destination views are given the results are copied into them.
    """
    dt = q.dtype
    b, tq, e = q.shape
    dh = e // num_heads
    p, qh, kh, vh = attention_probs(q, k, v, valid, num_heads, causal)
    doh = d_o.reshape(b, tq, num_heads, dh).transpose(1, 2).float()
    d_p = torch.matmul(doh, vh.float().transpose(-1, -2))
    d_v = torch.matmul(p.to(dt).float().transpose(-1, -2), doh).to(dt)
    d_s = p * (d_p - (d_p * p).sum(dim=-1, keepdim=True))
    d_s = (d_s * (1.0 / math.sqrt(dh))).to(dt).float()
    d_q = torch.matmul(d_s, kh.float()).to(dt)
    d_k = torch.matmul(d_s.transpose(-1, -2), qh.float()).to(dt)
    merge = lambda a: a.transpose(1, 2).reshape(b, a.shape[2], e)
    outs = [merge(d_q), merge(d_k), merge(d_v)]
    for i, dst in enumerate((dq, dk, dv)):
        if dst is not None:
            outs[i] = dst.copy_(outs[i])
    return tuple(outs)


def _launch(op, q, k, v, d_o, valid, num_heads, causal, dq=None, dk=None,
            dv=None):
    b, tq, tk, e, dh = check_attention_operands(op.name, q, k, v, valid,
                                                num_heads)
    bf = dict(dtype=torch.bfloat16, device=q.device)
    dq = torch.empty((b, tq, e), **bf) if dq is None else dq
    dk = torch.empty((b, tk, e), **bf) if dk is None else dk
    dv = torch.empty((b, tk, e), **bf) if dv is None else dv
    for name, a, t in (("d_o", d_o, tq), ("dq", dq, tq), ("dk", dk, tk),
                       ("dv", dv, tk)):
        if not a.is_cuda or a.dtype != torch.bfloat16 \
                or a.shape != (b, t, e) or a.stride(2) != 1 \
                or a.stride(0) != t * a.stride(1):
            raise ValueError(f"{op.name}: {name} must be a CUDA bf16 "
                             f"row-strided view of shape {(b, t, e)}")
    if d_o.stride(1) % 8 or dk.stride(1) != dv.stride(1):
        raise ValueError(f"{op.name}: unsupported strides")
    valid_u8 = valid.to(torch.uint8).contiguous()
    stats = torch.empty((3, b, num_heads, tq), dtype=torch.float32,
                        device=q.device)
    fn = _build.bind("attention_bwd", "acai_attention_bwd",
                     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), d_o.data_ptr(),
            valid_u8.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), b, tq, tk, num_heads, dh, q.stride(1),
            k.stride(1), d_o.stride(1), dq.stride(1), dk.stride(1),
            1.0 / math.sqrt(dh), int(causal), _build.stream_ptr())
    op.launched(f"dh{dh}")
    op.extra_launches += 1  # the dK/dV kernel after the dQ kernel
    _build.check(rc, op.name)
    return dq, dk, dv


attention_bwd = _build.KernelOp(
    "attention_bwd", "acai_omr_tpu_torch/csrc/attention_bwd.cu",
    "acai_omr_tpu/ops/pallas_train_layer.py:323 (_attend_bwd; _bwd_kernel "
    "loops :821-856 cross, :890-947 self)",
    _launch, attention_bwd_plain)
