"""K10 ``dropout``: a counter-based keep-mask, the same bits on every device.

CUDA sources: ``csrc/dropout.cuh`` (the device function the epilogues of K1,
K8 and K9 call) and ``csrc/dropout.cu`` (the standalone apply kernel). The
JAX package seeds the TPU's hardware generator per (layer, site, image)
(``ops/pallas_train_layer.py`` ``_drop_mask`` / ``_apply_drop``); that stream
cannot be reproduced, and its contract is only that the mask is a function
of the image's global index and regenerates identically in the backward.
Here the 32 bits of an element are Philox4x32-10 of

    key     = (seed0, seed1)
    counter = (column // 4, row within the image, image index, stream)

taking output word ``column % 4``; ``stream = layer * 8 + site`` inside the
stacks. ``keep <=> bits >= min(rate * 2**32, 2**32 - 1)``; survivors are
multiplied by ``float32(1 / (1 - rate))`` and rounded to the tensor's dtype.
:func:`drop_bits` computes the same bits with integer tensor ops, so the plain
twin drops exactly the elements the kernels drop.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

# stream ids outside the stacks (inside: layer * 8 + site, site in 0..3)
STREAM_TRANSITION_HEAD = 0xFFFF0001


@dataclasses.dataclass(frozen=True)
class DropSpec:
    """Everything that keys one dropout mask except the element's position.

    ``t`` is the number of rows one image owns in the (rows, width) tensor the
    mask is applied to; ``stream`` tells the sites apart.
    """
    rate: float
    seed0: int
    seed1: int
    stream: int
    t: int

    @property
    def thresh(self) -> int:
        return min(int(self.rate * 2.0 ** 32), 2 ** 32 - 1)

    @property
    def scale(self) -> float:
        return float(np.float32(1.0 / (1.0 - self.rate)))

    def at(self, stream: int) -> "DropSpec":
        return dataclasses.replace(self, stream=stream)

    def c_args(self) -> tuple:
        return (self.thresh, self.scale, self.seed0 & _MASK,
                self.seed1 & _MASK, self.stream & _MASK, self.t)


C_ARGTYPES = [ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32,
              ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
C_OFF = (0, 1.0, 0, 0, 0, 1)


def c_args(drop: DropSpec | None) -> tuple:
    """The six scalar arguments every kernel with a dropout epilogue takes."""
    return C_OFF if drop is None or drop.rate <= 0.0 else drop.c_args()


def _mix64(x: int) -> int:
    """splitmix64's finalizer."""
    x &= 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def fold_seed(seed: int, *path: int) -> tuple[int, int]:
    """(seed0, seed1) for one use of ``seed``: the seed is hashed, then each
    element of ``path`` is xor-ed in and the state hashed again (splitmix64's
    finalizer). Host integers only, so drawing seeds never waits for the
    card."""
    golden = 0x9E3779B97F4A7C15
    x = _mix64(seed + golden)
    for p in path:
        x = _mix64((x ^ (p & 0xFFFFFFFFFFFFFFFF)) + golden)
    return x & _MASK, x >> 32


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit halves of m * c for c < 2**32 held in int64, without
    leaving int64's range: m is split into 16-bit halves."""
    a = c * (m & 0xFFFF)
    b = c * (m >> 16)
    low = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (low >> 32), low & _MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32 with ten rounds on int64 tensors holding uint32 values."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def drop_bits(drop: DropSpec, rows: int, width: int, device,
              row_offset: int = 0) -> torch.Tensor:
    """(rows, width) int64 tensor of the uint32 bits of rows
    ``row_offset .. row_offset + rows`` of a tensor whose images own
    ``drop.t`` rows each."""
    if width % 4:
        raise ValueError(f"dropout needs width % 4 == 0, got {width}")
    r = torch.arange(row_offset, row_offset + rows, dtype=torch.int64,
                     device=device)[:, None]
    c4 = torch.arange(width // 4, dtype=torch.int64, device=device)[None, :]
    zeros = torch.zeros((rows, width // 4), dtype=torch.int64, device=device)
    words = philox4x32_10(c4 + zeros, r % drop.t + zeros, r // drop.t + zeros,
                          zeros + (drop.stream & _MASK), drop.seed0 & _MASK,
                          drop.seed1 & _MASK)
    return torch.stack(words, dim=-1).reshape(rows, width)


def keep_mask(drop: DropSpec, rows: int, width: int, device,
              row_offset: int = 0) -> torch.Tensor:
    return drop_bits(drop, rows, width, device, row_offset) >= drop.thresh


def dropout_plain(x: torch.Tensor, drop: DropSpec | None) -> torch.Tensor:
    """Plain twin: x (R, W) -> kept values times float32(scale), rounded to
    x's dtype; dropped values zero. ``None`` or rate 0 returns x."""
    if drop is None or drop.rate <= 0.0:
        return x
    keep = keep_mask(drop, x.shape[0], x.shape[1], x.device)
    scale = torch.full((), drop.scale, dtype=torch.float32, device=x.device)
    return torch.where(keep, (x.float() * scale).to(x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _launch(op, x, drop):
    if drop is None or drop.rate <= 0.0:
        return x
    _build.require(x, "x", torch.bfloat16, 2)
    rows, w = x.shape
    if w % 4:
        raise ValueError(f"dropout needs width % 4 == 0, got {w}")
    out = torch.empty_like(x)
    fn = _build.bind("dropout", "acai_dropout",
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                     + [ctypes.c_uint32, ctypes.c_float] + [ctypes.c_uint32] * 3
                     + [ctypes.c_void_p])
    thresh, scale, s0, s1, stream, t = drop.c_args()
    rc = fn(x.data_ptr(), out.data_ptr(), rows, w, t, thresh, scale, s0, s1,
            stream, _build.stream_ptr())
    op.launches += 1
    _build.check(rc, op.name)
    return out


dropout_apply = _build.KernelOp(
    "dropout", "acai_omr_tpu_torch/csrc/dropout.cu",
    "acai_omr_tpu/ops/pallas_train_layer.py:282 (_apply_drop, _drop_mask :266)",
    _launch, dropout_plain)


class _Dropout(torch.autograd.Function):
    """Dropout whose backward applies the forward's mask to the gradient
    (the same kernel with the same key)."""

    @staticmethod
    def forward(ctx, x, drop):
        ctx.drop = drop
        return dropout_apply(x, drop)

    @staticmethod
    def backward(ctx, g):
        return dropout_apply(g.contiguous(), ctx.drop), None


def dropout(x: torch.Tensor, drop: DropSpec | None) -> torch.Tensor:
    """Differentiable K10 on a (..., W) tensor whose images own ``drop.t``
    rows each once the leading dims are flattened."""
    if drop is None or drop.rate <= 0.0:
        return x
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    return _Dropout.apply(flat, drop).reshape(x.shape)
