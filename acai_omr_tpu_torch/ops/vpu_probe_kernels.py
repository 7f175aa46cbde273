"""The kernel of the elementwise-rate probe: K27 :data:`resident_elementwise`
(``csrc/resident_elementwise.cu``).

Port of the Pallas kernel of ``tools/vpu_probe.py`` (``run``, ``_kernel``),
which prices softmax, LayerNorm and the GELU forms per element on data held
on-chip: ``iters`` chained passes ``x <- work(x) + 0.5 x + (i & 1) 1e-6``
over one fp32 block. The port keeps its own copies of the JAX kernels' two
erf forms (``pallas_monolith._erf_rational`` / ``_erf_poly``) and their
coefficients, and adds ``gelu_erff``: CUDA's ``erff``, the GELU of the port's
own K1 / K5 / K14 epilogues (its plain twin uses ``torch.erf``). The kernel
lays each row over the lanes :func:`resident_plan` gives;
``variant="fixed"`` forces the kernel it replaced, kept as the yardstick, and
a layout ``"<L>x<V>"`` (``" smem"`` added: the sums through shared memory)
forces the plan kernel at a layout the source compiles.

:data:`OPS_PER_ELEMENT` counts, per element and pass, the fp32 instructions
(an FMA is one) and the MUFU operations (exp, reciprocal) of each work's
formula as K27 computes it; the probe's bound is the larger of the two at the
card's rates.
"""

from __future__ import annotations

import ctypes
import math
import re

import torch

from . import _build
from .linear_kernel import N_SMS

WORKS = ("softmax", "ln", "gelu", "gelu_poly", "gelu_erff")
COLS = (256, 768, 1024, 3072, 4096)  # compiled row widths
WARPS_PER_ROW = {256: 1, 768: 1, 1024: 1, 3072: 4, 4096: 4}  # "fixed"
# the plan kernel's lanes a row of softmax and ln, by row width
# (csrc/resident_elementwise.cu K27_PLANS): at most 32 values a lane
ROW_LANES = {256: 32, 768: 32, 1024: 32, 3072: 128, 4096: 128}
# softmax rows of 1,024 on 128 lanes (8 values a lane) where the rows put at
# most two such warps on an SM
WIDE_SOFTMAX_COLS, WIDE_SOFTMAX_LANES = 1024, 128
# the GELU works: pieces of 32 lanes x 8 values, four a block
PIECE_LANES, PIECE_VALUES, PIECES_PER_BLOCK = 32, 8, 4
VARIANTS = (None, "fixed")  # and the layouts LAYOUT matches
LAYOUT = re.compile(r"(\d+)x(\d+)( smem)?")
# |z| at which the plan kernel clamps the A&S erf's argument (ERF_ONE in the
# source): from |z| = 4 the formula rounds to 1.0f, so no bit changes
ERF_ONE = 8.0
LN_EPS = 1e-5
# fp32 instructions, MUFU operations per element and pass. softmax: max, sub,
# exp (4 + 1 MUFU), sum, scale, feedback (FMA + add); ln: sum, centre,
# square-sum, scale, feedback (the row's rsqrt is 1 / cols a value); gelu:
# the scaling, 1 + p a, the IEEE reciprocal (4 + 1 MUFU), the Horner chain
# (6), -a a, exp (4 + 1 MUFU), 1 - poly e, the sign, 1 + erf and two
# products, feedback; gelu_poly: scaling, a a, two 8-step Horner chains, u,
# a pin, three selects and compares, the sign, 1 + erf and two products,
# feedback; gelu_erff: CUDA's erff about 15 and one MUFU ex2, scaling, 1 +
# erf and two products, feedback.
OPS_PER_ELEMENT = {"softmax": (10, 1), "ln": (6, 0), "gelu": (24, 2),
                   "gelu_poly": (30, 0), "gelu_erff": (21, 1)}

# pallas_monolith's _ERF_P_INNER (|z| < 2: z P8(z^2)) and _ERF_Q_OUTER
# (2 <= |z| <= 4: Q8(|z| - 3)), lowest order first
ERF_P_INNER = (1.1283791196906645, -0.37612431815137987,
               0.11282301835706048, -0.02682474115101642,
               0.005165745149216882, -0.0008080523031585587,
               9.773775549318082e-05, -7.991255935925338e-06,
               3.205006352036684e-07)
ERF_Q_OUTER = (0.9999779388686203, 0.00013951109721889064,
               -0.00041936053857775154, 0.0007858608011556055,
               -0.0010307062836143713, 0.0010255980999460375,
               -0.0007781201077135403, 0.00038805285608613824,
               -8.875076493734391e-05)


def erf_rational(z: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 rational erf (max abs err 1.5e-7), fp32,
    as the JAX kernels' ``_erf_rational``."""
    a = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    y = 1.0 - poly * torch.exp(-a * a)
    return torch.where(z < 0, -y, y)


def erf_poly(z: torch.Tensor) -> torch.Tensor:
    """The exp- and divide-free two-branch polynomial erf, as the JAX
    kernels' ``_erf_poly``: both branches evaluated, one selected."""
    a = z.abs()
    z2 = a * a
    pin = torch.full_like(a, ERF_P_INNER[-1])
    for coef in ERF_P_INNER[-2::-1]:
        pin = pin * z2 + coef
    u = a - 3.0
    q = torch.full_like(a, ERF_Q_OUTER[-1])
    for coef in ERF_Q_OUTER[-2::-1]:
        q = q * u + coef
    y = torch.where(a < 2.0, a * pin, torch.where(a <= 4.0, q, 1.0))
    return torch.where(z < 0, -y, y)


def _softmax(x):
    w = torch.exp(x - x.amax(dim=1, keepdim=True))
    return w / w.sum(dim=1, keepdim=True)


def _ln(x):
    c = x - x.mean(dim=1, keepdim=True)
    return c * torch.rsqrt((c * c).mean(dim=1, keepdim=True) + LN_EPS)


_SQRT2 = math.sqrt(2.0)
WORK_FN = {
    "softmax": _softmax,
    "ln": _ln,
    "gelu": lambda x: 0.5 * x * (1.0 + erf_rational(x / _SQRT2)),
    "gelu_poly": lambda x: 0.5 * x * (1.0 + erf_poly(x / _SQRT2)),
    "gelu_erff": lambda x: 0.5 * x * (1.0 + torch.erf(x / _SQRT2)),
}


def check_block(x: torch.Tensor, work: str, iters: int,
                variant: str | None = None) -> None:
    """Raise on what K27 does not take."""
    if variant not in VARIANTS and not (
            isinstance(variant, str) and LAYOUT.fullmatch(variant)):
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS} "
                         f"or a layout '<L>x<V>[ smem]'")
    if work not in WORKS:
        raise ValueError(f"work must be one of {WORKS}, got {work!r}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("x must be (rows, cols) fp32")
    rows, cols = x.shape
    if cols not in COLS:
        raise ValueError(f"cols must be one of {COLS}, got {cols}")
    if rows == 0 or rows % (4 // WARPS_PER_ROW[cols]):
        raise ValueError(f"rows must be a positive multiple of "
                         f"{4 // WARPS_PER_ROW[cols]} at cols={cols}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def resident_elementwise_plain(x: torch.Tensor, work: str,
                               iters: int) -> torch.Tensor:
    """Plain twin of K27: ``iters`` passes of ``work(x) + 0.5 x + (i & 1)
    1e-6`` in fp32, as ``tools/vpu_probe._kernel``'s loop."""
    check_block(x, work, iters)
    fn = WORK_FN[work]
    for i in range(iters):
        x = fn(x) + x * 0.5 + (i & 1) * 1e-6
    return x.clone() if iters == 0 else x


def resident_plan(rows: int, cols: int, work: str,
                  variant: str | None = None) -> tuple[int, int, int, bool]:
    """(lanes, values a lane, pieces a block, shared sums) of the plan
    kernel. softmax and ln: a piece is a row, on :data:`ROW_LANES` lanes
    (whole warps, at most 32 values a lane), one a block, so 256 rows launch
    256 blocks; softmax rows of 1,024 take 128 lanes of 8 values where the
    rows are at most two an SM (there a lane's 32 exponentials, not the
    reductions, are the longer chain). Where one-warp ln rows are at most
    two an SM (one wave that leaves the SMs idle), a row's two sums go
    through shared memory, a shorter chain than the shuffle butterfly,
    which wins once the SMs are busy (softmax has one sum, and gains
    nothing). ``chip_smoke.py --k27-plan`` times each choice against the
    other. The GELU works: pieces of 32 lanes x 8 values, four a block. A
    layout ``variant`` replaces the lanes, the values and the shared
    sums."""
    if cols not in ROW_LANES or work not in WORKS:
        raise ValueError(f"no plan for {work!r} at cols={cols}")
    forced = LAYOUT.fullmatch(variant or "")
    if forced:
        return (int(forced[1]), int(forced[2]),
                PIECES_PER_BLOCK if work.startswith("gelu") else 1,
                bool(forced[3]))
    if work.startswith("gelu"):
        return PIECE_LANES, PIECE_VALUES, PIECES_PER_BLOCK, False
    few = rows <= 2 * N_SMS
    lanes = ROW_LANES[cols]
    if work == "softmax" and cols == WIDE_SOFTMAX_COLS and few:
        lanes = WIDE_SOFTMAX_LANES
    return lanes, cols // lanes, 1, work == "ln" and few and lanes == 32


def plan_variant(rows: int, cols: int, work: str,
                 variant: str | None = None) -> str:
    """The plan kernel's variant for these rows: "<work> <cols> <L>x<V>",
    " smem" added where its sums go through shared memory."""
    lanes, values, _, smem = resident_plan(rows, cols, work, variant)
    return f"{work} {cols} {lanes}x{values}" + (" smem" if smem else "")


def _launch(op, x, work, iters, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"fixed"`` forces
    the kernel the plan kernel replaced, a layout ``"<L>x<V>[ smem]"`` the
    plan kernel at that layout."""
    check_block(x, work, iters, variant)
    _build.require(x, "x", torch.float32, 2)
    rows, cols = x.shape
    out = torch.empty_like(x)
    args = (x.data_ptr(), out.data_ptr(), rows, cols, WORKS.index(work),
            iters)
    if variant == "fixed":
        fn = _build.bind("resident_elementwise", "acai_resident_elementwise",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
        rc = fn(*args, _build.stream_ptr())
        op.launched(f"{work} {cols} fixed")
    else:
        lanes, values, per_block, smem = resident_plan(rows, cols, work,
                                                       variant)
        fn = _build.bind("resident_elementwise",
                         "acai_resident_elementwise_plan",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                         + [ctypes.c_void_p])
        rc = fn(*args, lanes, values, per_block, int(smem),
                _build.stream_ptr())
        op.launched(plan_variant(rows, cols, work, variant))
    _build.check(rc, op.name)
    return out


resident_elementwise = _build.KernelOp(
    "resident_elementwise", "acai_omr_tpu_torch/csrc/resident_elementwise.cu",
    "tools/vpu_probe.py:85 (run, _kernel :76, pallas_call :91)",
    _launch, resident_elementwise_plain, check_block)


def bound_s(work: str, elems: int, iters: int, sm_clock_hz: float,
            sms: int, fp32_lanes: int, mufu_lanes: int) -> float:
    """Least seconds of ``iters`` passes over ``elems`` values: the fp32
    instructions at ``fp32_lanes`` a SM a clock or the MUFU operations at
    ``mufu_lanes``, whichever is longer."""
    fp32, mufu = OPS_PER_ELEMENT[work]
    per_s = sms * sm_clock_hz
    return elems * iters * max(fp32 / (fp32_lanes * per_s),
                               mufu / (mufu_lanes * per_s))
