"""K1 ``linear_bias_act``: act(x @ w + b) with an fp32 accumulator.

CUDA source: ``csrc/linear_bias_act.cu`` (bound, design and the TPU kernel it
replaces are noted there) with the Hopper GEMM core ``csrc/sm90_gemm.cuh``.
Serves every product inside the two ported stacks: the skinny decode rows
(M = B) and the encoder and training rows (M = B*T). :func:`gemm_plan` picks
the kernel by M: ``"sm90"`` (TMA + wgmma, 128 x BN tiles) for the large-M
products, ``"skinny"`` (one launch, K split across a thread-block cluster,
:func:`skinny_plan`) for the decode rows; ``KernelOp.variants`` counts the
launches of each (``"skinny_partial"``: the skinny kernel's fp32 partials of
the meshed decode). ``variant="wmma"`` forces the pre-Hopper kernel the
decode rows took before (split K and a second launch, :func:`split_plan`;
its partials count as ``"partial"``), kept as the yardstick.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import dropout_kernel as dk

ACTS = {"none": 0, "gelu": 1, "gelu_rounded": 2, "partial": 3}
_BM, _BN, _BK = 64, 64, 32
N_SMS = 132  # an H100 SXM's streaming multiprocessors
_TARGET_BLOCKS = 2 * N_SMS  # two waves of blocks
SM90_BM = 128
SM90_BNS = (256, 128)
SKINNY_M = 128  # the most rows the decode products have (GRPO: 16 x 8)
VARIANTS = ("sm90", "skinny", "wmma")
# the skinny kernel: 64 x 64 weight tiles a k-step, a ring of four stages,
# K split across at most one portable thread-block cluster
SKINNY_BN = SKINNY_BK = 64
SKINNY_STAGES = 4
SKINNY_MAX_SPLIT = 8


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


def skinny_plan(m: int, n: int, k: int) -> tuple[int, int]:
    """(k_chunk, split) of the skinny kernel for an M x K by K x N product,
    M <= SKINNY_M: a block owns SKINNY_BN columns and k_chunk of K (a
    multiple of 64); the ``split`` blocks of one column tile form one
    cluster and sum their partials in rank order, ranges in order and none
    empty. The split gives the grid at least one block an SM (all 132
    wherever the column tiles times SKINNY_MAX_SPLIT reach them) and each
    block at most a ring's depth of k-steps, so that all its weight loads
    are in flight at once. Narrower tiles or clusters past 8 blocks, which
    would cover the SMs at every shape, measured slower on an H100."""
    del m  # the rows set the consumer warpgroups, not the plan
    tiles, steps = -(-n // SKINNY_BN), -(-k // SKINNY_BK)
    want = min(SKINNY_MAX_SPLIT, steps,
               max(-(-steps // SKINNY_STAGES), -(-N_SMS // tiles)))
    chunk = max(steps // want, -(-steps // SKINNY_MAX_SPLIT))
    return chunk * SKINNY_BK, -(-steps // chunk)


def waves(blocks: int) -> int:
    """Waves of ``blocks`` resident one an SM on the card's SMs."""
    return -(-blocks // N_SMS)


def wave_waste(blocks: int) -> float:
    """The share of the SM slots of ``blocks``' waves that no block fills."""
    return 1.0 - blocks / (waves(blocks) * N_SMS)


# The core's time model, one block an SM: a 128 x BN tile's k-step (64 deep)
# at 90 % of an SM's share of 989 TFLOP/s bf16, plus a fixed cost a tile
# (filling the ring, staging and storing the epilogue). Both are fit to the
# core's times on an H100 (PERF.md section 6: K1 at K = 768 and K = 3,072).
CORE_STEP_S = {bn: 2 * SM90_BM * bn * 64 / (0.9 * 989e12 / N_SMS)
               for bn in SM90_BNS}
CORE_TILE_S = 10e-6


def core_s(blocks: int, k_steps: int, bn: int) -> float:
    """Modelled seconds of ``blocks`` tiles of ``k_steps`` k-steps each."""
    return waves(blocks) * (k_steps * CORE_STEP_S[bn] + CORE_TILE_S)


def sm90_tile_n(m: int, n: int, k: int) -> int:
    """BN of the core's 128 x BN tiles for an M x K by K x N product: the
    one :func:`core_s` models faster, ties to 256 (each row of x read half
    as often). Wide tiles pay the fixed cost a tile fewer times; narrow ones
    fill the last wave better. At every large-M shape the port runs
    (PERF.md section 6) the choice leaves under 30 % of its waves' SM slots
    empty (:func:`wave_waste`)."""
    m_tiles, steps = -(-m // SM90_BM), -(-k // 64)
    return min(SM90_BNS, key=lambda bn: (
        core_s(m_tiles * -(-n // bn), steps, bn), -bn))


def gemm_plan(m: int, n: int, k: int) -> tuple[str, int]:
    """(variant, BN): the kernel for an M x K by K x N product.

    ``"skinny"`` for M <= SKINNY_M: the decode rows (decode, beams, GRPO's
    rollouts of up to 128 rows, the meshed partials) read the whole weight
    matrix for a few rows, so they are bound by weight bytes; the core would
    give them one row of N / BN <= 32 tiles, each streaming its columns of W
    for all of K on one SM, a quarter of the card's 132 SMs, while
    :func:`skinny_plan` spreads the same bytes over every SM and sums the
    split K in one launch. ``"sm90"`` for everything else: the encoder's
    M = B*T, stage 2's 2,048 / 8,192 rows, the MAE's 32,768, with BN from
    :func:`sm90_tile_n`. Both take TMA's shape rule (K, N multiples of 8)."""
    if m <= SKINNY_M:
        return "skinny", SKINNY_BN
    return "sm90", sm90_tile_n(m, n, k)


def linear_takes(variant: str, k: int, n: int) -> bool:
    """K1's shape rule for the kernel ``variant``: TMA's 16-byte row strides
    (K, N multiples of 8); the wmma kernel's tiles also K % 32 == 0 and
    N % 64 == 0."""
    if variant == "wmma" and (k % _BK or n % _BN):
        return False
    return k % 8 == 0 and n % 8 == 0


def _check_shape(variant: str, k: int, n: int) -> None:
    if linear_takes(variant, k, n):
        return
    if variant == "wmma" and (k % _BK or n % _BN):
        raise ValueError(f"linear_bias_act's wmma kernel needs K % {_BK} == 0 "
                         f"and N % {_BN} == 0, got K={k}, N={n}")
    if k % 8 or n % 8:
        raise ValueError(f"linear_bias_act needs K % 8 == 0 and N % 8 == 0 "
                         f"(TMA's 16-byte row strides), got K={k}, N={n}")


def _launch(op, x, w, b, act="none", drop=None, save_gelu_grad=False, *,
            variant=None):
    """``variant`` (private: tests and chip_smoke.py) forces ``"sm90"``,
    ``"skinny"`` or ``"wmma"`` in place of :func:`gemm_plan`'s choice."""
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
    plan = gemm_plan(m, n, k)[0]
    if variant is not None:
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        if variant == "skinny" and m > SKINNY_M:
            raise ValueError(f"the skinny kernel takes at most {SKINNY_M} "
                             f"rows, got {m}")
        plan = variant
    _check_shape(plan, k, n)
    if plan != "wmma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("linear_bias_act needs x and w 16-byte aligned")
    if x.device != w.device or (b is not None and x.device != b.device):
        raise ValueError("x, w and b must be on one device")
    if save_gelu_grad and act != "gelu":
        raise ValueError("save_gelu_grad needs act='gelu'")
    if partial and drop is not None:
        raise ValueError("the partial product takes no dropout")
    out = torch.empty((m, n), dtype=torch.float32 if partial
                      else torch.bfloat16, device=x.device)
    gp = torch.empty_like(out) if save_gelu_grad else None
    bias_ptr = None if b is None else b.data_ptr()
    gp_ptr = None if gp is None else gp.data_ptr()
    if plan == "wmma":
        k_chunk, splits = split_plan(m, n, k)
        part = (torch.empty((splits, m, n), dtype=torch.float32,
                            device=x.device) if splits > 1 else None)
        fn = _build.bind("linear_bias_act", "acai_linear_bias_act",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                         + dk.C_ARGTYPES + [ctypes.c_void_p])
        rc = fn(x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(), gp_ptr,
                None if part is None else part.data_ptr(), m, n, k, k_chunk,
                splits, ACTS[act], *dk.c_args(drop), _build.stream_ptr())
        # the tensor-parallel step's partials are counted apart
        op.launched("partial" if partial else "wmma")
        op.extra_launches += part is not None  # the split-K reduce kernel
    elif plan == "skinny":
        k_chunk, split = skinny_plan(m, n, k)
        fn = _build.bind("linear_bias_act", "acai_linear_bias_act_skinny",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                         + dk.C_ARGTYPES + [ctypes.c_void_p])
        rc = fn(x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(), gp_ptr,
                m, n, k, k_chunk, split, ACTS[act], *dk.c_args(drop),
                _build.stream_ptr())
        op.launched("skinny_partial" if partial else "skinny")
    else:
        fn = _build.bind("linear_bias_act", "acai_linear_bias_act_sm90",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + dk.C_ARGTYPES + [ctypes.c_void_p])
        rc = fn(x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(), gp_ptr,
                m, n, k, sm90_tile_n(m, n, k), ACTS[act], *dk.c_args(drop),
                _build.stream_ptr())
        op.launched(plan)
    _build.check(rc, op.name)
    return (out, gp) if save_gelu_grad else out


linear_bias_act = _build.KernelOp(
    "linear_bias_act", "acai_omr_tpu_torch/csrc/linear_bias_act.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:1358 (_kernel mat dots) and "
    "acai_omr_tpu/ops/pallas_train_layer.py:472 (_fwd_kernel dots)",
    _launch, linear_bias_act_plain)
