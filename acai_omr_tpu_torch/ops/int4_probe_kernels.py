"""The kernels of the int4 probes: K20 :data:`int4_delivery_gemm` and K21
:data:`int4_unpack` (``csrc/int4_probe.cu``).

Port of the Pallas kernels of ``tools/int4_probe.py`` (``run_variant`` /
``time_variant``) and ``tools/unpack_probe.py`` (``run``), which ask how int4
weights should reach the int8 dot of the W4A8 decode product (K14). Every
scheme computes one function from the same int4 values, so the wrappers pack
each scheme's operand from ``lo`` and ``hi`` (:func:`scheme_weights`) and the
plain twins compute the exact product or the unpacked rows.

Int4 values are in [-8, 7]. The TPU's byte packing (``pack_bytes``) holds a
``lo`` and a ``hi`` value in one byte, ``(hi << 4) | (lo + 8)``; K14's words
(:func:`quant_linear_kernel.pack_k8_int4`) hold eight K rows, each nibble
the value plus 8, so -8 is the nibble 0 on both sides.

K20 runs each strip of 32 output columns over the whole contraction in one
block on the tensor cores (:func:`strip_plan`: a K split across a cluster
only where the strips cannot fill the card); ``variant="atomic"`` forces the
kernel it replaced (the contraction split over blocks whose sums meet by
integer atomics in a zeroed output), kept as the yardstick.

K21 unpacks whole words, each thread with four 16-byte pieces in flight
(:func:`unpack_plan`, :func:`unpack_walk`; eyedot a warp a 16 x 128 tile on
``mma.sync``); ``variant="bytewise"`` forces the byte-at-a-time kernels it
replaced.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .linear_kernel import N_SMS
from .quant_linear_kernel import (pack_k4, pack_k8_int4, unpack_k4,
                                  unpack_k8_int4)

GEMM_SCHEMES = ("i8ref", "s4dot", "s4conv", "i8shift", "f32unpack")
BYTE_SCHEMES = ("i8shift", "f32unpack")
UNPACK_SCHEMES = ("f32", "i32", "i16", "i8div", "eyedot")
MAX_ROWS = 32
UNIT = 64  # x columns per contraction unit of K20
SMEM_X_BYTES = 48 * 1024  # the atomic form stages its split's x in 48 KB
TARGET_BLOCKS = 2 * N_SMS  # the atomic form: two waves of blocks
STRIP_COLS = 32  # K20: output columns a block
STRIP_FILL = N_SMS // 2  # strips that fill the card without a split
SPLIT_MIN_BYTES = 32 * 1024  # a strip's weight bytes worth a cluster's launch
MAX_SPLIT = 8  # a portable cluster


def pack_bytes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int4 values in [-8, 7] -> int8 bytes ``(hi << 4) | (lo + 8)``, as the
    TPU tools' ``pack_bytes`` / ``pack``."""
    b = (hi.to(torch.int32) << 4) | ((lo.to(torch.int32) + 8) & 0xF)
    return torch.where(b >= 128, b - 256, b).to(torch.int8)


def unpack_bytes(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_bytes`: ``hi = floor(b / 16)``, ``lo = b - 16
    hi - 8``, as int8."""
    v = b.to(torch.int32)
    hi = torch.div(v, 16, rounding_mode="floor")
    return (v - 16 * hi - 8).to(torch.int8), hi.to(torch.int8)


def scheme_weights(lo: torch.Tensor, hi: torch.Tensor,
                   scheme: str) -> torch.Tensor:
    """K20's weight operand for ``scheme`` from ``lo`` and ``hi`` (cin/2,
    cout) int4 values, W = lo ‖ hi along the rows: ``i8ref`` (cin/4, cout,
    4) int8; ``s4dot`` / ``s4conv`` (cin/8, cout) int32; ``i8shift`` /
    ``f32unpack`` (cin/2, cout) int8 bytes."""
    _scheme(scheme)
    if scheme in BYTE_SCHEMES:
        return pack_bytes(lo, hi)
    w = torch.cat([lo, hi], 0)
    return pack_k4(w.to(torch.int8)) if scheme == "i8ref" else pack_k8_int4(w)


def full_weights(w: torch.Tensor, scheme: str) -> torch.Tensor:
    """The (cin, cout) int8 values a K20 operand holds."""
    if scheme in BYTE_SCHEMES:
        return torch.cat(unpack_bytes(w), 0)
    return unpack_k4(w) if scheme == "i8ref" else unpack_k8_int4(w)


def _scheme(scheme: str) -> None:
    if scheme not in GEMM_SCHEMES:
        raise ValueError(f"scheme must be one of {GEMM_SCHEMES}, got "
                         f"{scheme!r}")


def _weight_shape(scheme: str, cin: int, cout: int) -> tuple:
    if scheme in BYTE_SCHEMES:
        return (cin // 2, cout)
    return (cin // 4, cout, 4) if scheme == "i8ref" else (cin // 8, cout)


def gemm_plan(x: torch.Tensor, w: torch.Tensor, scheme: str,
              variant=None) -> tuple:
    """(bt, cin, cout) of a K20 call; raises on what the kernel does not
    take: bt outside 1..32, cin % 64, cout not a multiple of 128 (words) or
    512 (the byte layouts), a weight of another shape, an unknown
    ``variant`` (None, ``"atomic"``, ``"split{s}"`` with s in 1, 2, 4, 8
    dividing cin / 64)."""
    _scheme(scheme)
    if x.dim() != 2:
        raise ValueError("x must be (bt, cin)")
    bt, cin = x.shape
    cout = w.shape[1]
    cols = 4 * 128 if scheme in BYTE_SCHEMES else 128
    if not 1 <= bt <= MAX_ROWS:
        raise ValueError(f"bt must be 1..{MAX_ROWS}, got {bt}")
    if cin % UNIT or cin <= 0:
        raise ValueError(f"cin must be a positive multiple of {UNIT}, "
                         f"got {cin}")
    if cout % cols or cout <= 0:
        raise ValueError(f"{scheme}: cout must be a multiple of {cols}, got "
                         f"{cout}")
    if tuple(w.shape) != _weight_shape(scheme, cin, cout):
        raise ValueError(f"{scheme} weights must be "
                         f"{_weight_shape(scheme, cin, cout)}, got "
                         f"{tuple(w.shape)}")
    _forced_split(variant, cin)
    return bt, cin, cout


def _forced_split(variant, cin: int):
    """The split ``variant`` forces (None: the plan's; ``"atomic"``: none)."""
    if variant is None or variant == "atomic":
        return None
    s = variant[5:] if isinstance(variant, str) \
        and variant.startswith("split") else ""
    if s not in ("1", "2", "4", "8") or cin % (UNIT * int(s)):
        raise ValueError(f"unknown variant {variant!r}: None, 'atomic' or "
                         f"'split{{s}}' (s in 1, 2, 4, 8 dividing cin / "
                         f"{UNIT})")
    return int(s)


def strip_rows(bt: int) -> int:
    """The x rows of K20's boxes: bt padded with zeros to 8, 16 or 32."""
    return 8 if bt <= 8 else 16 if bt <= 16 else 32


def strip_column(scheme: str, j: int, g: int) -> int:
    """The column of a strip that K20's mma n-slot g of 8-column tile j
    holds (``csrc/int4_probe.cu`` ``strip_kernel``): 8 j + g for the word
    layouts; 4 g + j for the byte layouts, whose thread loads the word of
    its four columns 4 g .. 4 g + 3."""
    return 4 * g + j if scheme in BYTE_SCHEMES else 8 * j + g


def strip_bytes(scheme: str, cin: int) -> int:
    """The weight bytes of one strip of 32 columns over all of cin."""
    return cin * STRIP_COLS // (1 if scheme == "i8ref" else 2)


def strip_plan(bt: int, cin: int, cout: int, scheme: str,
               variant=None) -> tuple[int, int]:
    """(strips, split) of a K20 call: cout / 32 strips, each over the whole
    contraction in one block; split > 1 (a cluster of split blocks along K)
    only where the strips cannot fill the card (fewer than half its SMs) and
    a strip is deep enough (more than 32 KB of weights) to be worth the
    cluster launch's fixed cost: the least power of two, at most 8, that
    brings the blocks to half the SMs, each block at least 64 k.
    ``variant="split{s}"`` forces s."""
    _scheme(scheme)
    strips = cout // STRIP_COLS
    forced = _forced_split(variant, cin)
    if forced is not None:
        return strips, forced
    split = 1
    if strips < STRIP_FILL and strip_bytes(scheme, cin) > SPLIT_MIN_BYTES:
        while (split < MAX_SPLIT and strips * split < STRIP_FILL
               and cin % (UNIT * 2 * split) == 0):
            split *= 2
    return strips, split


def atomic_splits(bt: int, cin: int, cout: int, scheme: str) -> int:
    """The contraction splits of the atomic form: enough blocks for two
    waves, and the split's x rows within 48 KB."""
    cols = 4 * 128 if scheme in BYTE_SCHEMES else 128
    rows = strip_rows(bt)
    units = cin // UNIT
    need = min(units, max(-(-TARGET_BLOCKS // (cout // cols)),
                          -(-rows * cin // SMEM_X_BYTES)))
    return next(d for d in range(need, units + 1) if units % d == 0)


def int4_delivery_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                             scheme: str) -> torch.Tensor:
    """Plain twin of K20: the exact product of the int8 rows and the int4
    weights as int32 (through float64, exact below 2^53)."""
    gemm_plan(x, w, scheme)
    wf = full_weights(w, scheme)
    return torch.round(x.double() @ wf.double()).to(torch.int32)


def _launch_gemm(op, x, w, scheme, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"atomic"`` forces
    the kernel this one replaced, ``"split{s}"`` a split of the contraction
    across a cluster of s blocks."""
    bt, cin, cout = gemm_plan(x, w, scheme, variant)
    _build.require(x, "x", torch.int8, 2)
    _build.require(w, "w", torch.int32 if scheme in ("s4dot", "s4conv")
                   else torch.int8, w.dim())
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    if variant == "atomic":
        splits = atomic_splits(bt, cin, cout, scheme)
        out = (torch.zeros if splits > 1 else torch.empty)(
            (bt, cout), dtype=torch.int32, device=x.device)
        fn = _build.bind("int4_probe", "acai_int4_delivery_gemm",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                GEMM_SCHEMES.index(scheme), bt, cin, cout, splits,
                _build.stream_ptr())
        op.launched(f"{scheme} atomic")
        if splits > 1:
            op.extra_launches += 1  # the memset of the output
    else:
        if x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("x and w must be 16-byte aligned")
        _, split = strip_plan(bt, cin, cout, scheme, variant)
        out = torch.empty((bt, cout), dtype=torch.int32, device=x.device)
        fn = _build.bind("int4_probe", "acai_int4_delivery_gemm_strip",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                GEMM_SCHEMES.index(scheme), bt, cin, cout, split,
                _build.stream_ptr())
        op.launched(scheme if split == 1 else f"{scheme} split{split}")
    _build.check(rc, op.name)
    return out


int4_delivery_gemm = _build.KernelOp(
    "int4_delivery_gemm", "acai_omr_tpu_torch/csrc/int4_probe.cu",
    "tools/int4_probe.py:96 (run_variant, pallas_call :112); :130 "
    "(time_variant, pallas_call :147)", _launch_gemm,
    int4_delivery_gemm_plain, gemm_plan)


UNPACK_THREADS = 128  # K21's block
UNPACK_VEC = 4  # 16-byte pieces a thread loads at once (64 bytes)
UNPACK_BLOCKS_PER_SM = 4
EYE_COLS = 128  # packed columns of eyedot's warp tile (16 rows)
UNPACK_VARIANTS = (None, "bytewise")


def _check_unpack(packed: torch.Tensor, scheme: str = "i32", reps: int = 1,
                  variant=None) -> None:
    if variant not in UNPACK_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: None (word-wide) or "
                         f"'bytewise'")
    if scheme not in UNPACK_SCHEMES:
        raise ValueError(f"scheme must be one of {UNPACK_SCHEMES}, got "
                         f"{scheme!r}")
    if packed.dim() != 2 or packed.dtype != torch.int8:
        raise ValueError("packed must be (half, cols) int8")
    half, cols = packed.shape
    if half % 16 or cols % 16 or half == 0 or cols == 0:
        raise ValueError(f"packed (half, cols) must be multiples of 16, got "
                         f"{(half, cols)}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")


def unpack_plan(half: int, cols: int, scheme: str = "i32") -> tuple[int, int]:
    """(blocks, pieces a thread) of a K21 call on a packed (half, cols)
    block: 128-thread blocks, each thread owning four 16-byte pieces (64
    bytes) a round, as many blocks as one round of the whole block needs up
    to four an SM, then more rounds (:func:`unpack_walk`). eyedot counts in
    warp tiles of 16 rows x 128 columns (fewer at a ragged right edge), a
    tile four pieces a lane."""
    if scheme == "eyedot":
        units = (half // 16) * -(-cols // EYE_COLS)  # a warp's tiles
        per_block = UNPACK_THREADS // 32
    else:
        units = half * cols // 16  # pieces
        per_block = UNPACK_THREADS * UNPACK_VEC
    blocks = min(-(-units // per_block), UNPACK_BLOCKS_PER_SM * N_SMS)
    rounds = -(-units // (blocks * per_block))
    return blocks, UNPACK_VEC * rounds


def unpack_walk(half: int, cols: int, scheme: str = "i32") -> torch.Tensor:
    """The 16-byte pieces of a packed (half, cols) block each thread of
    K21's word-wide kernel reads (``csrc/int4_probe.cu``), as piece indices
    (row-major, cols / 16 a row), -1 where a read is past the end or the
    thread has no tile: (threads of the grid, pieces a thread). Thread g
    reads pieces g + (4 r + j) x (the grid's threads), j = 0..3, in round r;
    eyedot's lane (g, t) of warp w reads rows 4t .. 4t + 3 of column group
    4 (g & 1) + g / 2 (16 bytes) of tiles w, w + (the grid's warps), ..."""
    blocks, pieces = unpack_plan(half, cols, scheme)
    threads = blocks * UNPACK_THREADS
    n = half * cols // 16
    if scheme != "eyedot":
        idx = (torch.arange(threads, dtype=torch.int64)[:, None]
               + torch.arange(pieces, dtype=torch.int64)[None, :] * threads)
        return torch.where(idx < n, idx, torch.full_like(idx, -1))
    warps = threads // 32
    tiles_n = -(-cols // EYE_COLS)
    tiles = (half // 16) * tiles_n
    lane = torch.arange(threads) % 32
    g, t = lane // 4, lane % 4
    wid = torch.arange(threads) // 32
    out = []
    for r in range(pieces // UNPACK_VEC):
        tile = wid + r * warps
        r0 = (tile // tiles_n) * 16
        c0 = (tile % tiles_n) * EYE_COLS
        col = c0 + 16 * (4 * (g % 2) + g // 2)
        ok = (tile < tiles) & (col < cols)
        for i in range(4):
            idx = (r0 + 4 * t + i) * (cols // 16) + col // 16
            out.append(torch.where(ok, idx, torch.full_like(idx, -1)))
    return torch.stack(out, 1)


def int4_unpack_plain(packed: torch.Tensor, scheme: str = "i32",
                      reps: int = 1) -> torch.Tensor:
    """Plain twin of K21: lo rows then hi rows, ``(2 half, cols)`` int8 (the
    reps repeat the same unpack)."""
    _check_unpack(packed, scheme, reps)
    return torch.cat(unpack_bytes(packed), 0)


def _launch_unpack(op, packed, scheme="i32", reps=1, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"bytewise"`` forces
    the kernels this one replaced."""
    _check_unpack(packed, scheme, reps, variant)
    _build.require(packed, "packed", torch.int8, 2)
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned")
    half, cols = packed.shape
    out = torch.empty((2 * half, cols), dtype=torch.int8,
                      device=packed.device)
    if variant == "bytewise":
        fn = _build.bind("int4_probe", "acai_int4_unpack_bytewise",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
        rc = fn(packed.data_ptr(), out.data_ptr(),
                UNPACK_SCHEMES.index(scheme), half, cols, reps,
                _build.stream_ptr())
        op.launched(f"{scheme} bytewise")
    else:
        blocks, pieces = unpack_plan(half, cols, scheme)
        fn = _build.bind("int4_probe", "acai_int4_unpack",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
        rc = fn(packed.data_ptr(), out.data_ptr(),
                UNPACK_SCHEMES.index(scheme), half, cols, blocks,
                pieces // UNPACK_VEC, reps, _build.stream_ptr())
        op.launched(scheme)
    _build.check(rc, op.name)
    return out


int4_unpack = _build.KernelOp(
    "int4_unpack", "acai_omr_tpu_torch/csrc/int4_probe.cu",
    "tools/unpack_probe.py:112 (run, KERNELS :108, pallas_call :124)",
    _launch_unpack, int4_unpack_plain, _check_unpack)
