"""The kernels of the GEMM, decode-attention and scratch probes.

Port of the Pallas kernels of the JAX package's probe tools (``tools/``),
which ask the questions a redesign of the training products and the decode
attention has to answer on the card:

* K16 :data:`tile_gemm` (``csrc/tile_gemm.cu``): ``tools/pallas_gemm_probe.py``
  ``make_mm`` and ``tools/mosaic_dot_forms_probe.py`` ``make_kernel``, one
  tensor-core GEMM over (BM, BN, BK) tiles in three operand layouts, on
  persistent blocks (:func:`tile_gemm_blocks`) that walk the tiles of
  :func:`tile_gemm_schedule` (TMA + ``wgmma``); ``variant="wmma"`` forces the
  kernel it replaced, kept as the yardstick.
* K17 :data:`blockdiag_decode_attention` and K18
  :data:`batched_decode_attention` (``csrc/probe_decode_attention.cu``):
  ``tools/attn_microbench.py`` ``blockdiag_attn`` and ``batcheddot_attn``.
  K17 runs one thread-block cluster a row, the row's keys split across it as
  :func:`blockdiag_plan` says (counted as ``"{cache} bt={bt} split{s}"``);
  ``variant="wmma"`` forces the kernel it replaced, kept as the yardstick.
  K18 runs one block per (row, head) over whole planes, its loads as
  :func:`batched_route` picks (counted as ``"bt={bt} {route}"``);
  ``variant="warp"`` forces the kernel it replaced.
* K19 :data:`smem_probe` (``csrc/smem_probe.cu``): ``tools/vmem_probe.py``
  ``probe``, one warp with no barrier, launched as a programmatic dependent
  launch, its shared-memory attribute set
  only for a size past the largest set (:func:`smem_set_max`);
  ``variant="simple"`` forces the kernel it replaced.

Each has its plain PyTorch twin beside it, which the CPU tests use and the
card is held against.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import _build
from .linear_kernel import N_SMS

# K16's compiled variants: (layout, out dtype) -> (BM, BN, BK) tiles. The
# sweep's tiles fit Hopper's shared memory (at 128x256x64 three 48 KB stages
# beside the 64 KB bf16 staging); the dot forms run at two tiles.
SWEEP_TILES = tuple((bm, bn, bk) for bm, bn in ((64, 64), (128, 64), (64, 128),
                                                (128, 128), (128, 256))
                    for bk in (32, 64))
FORM_TILES = ((64, 64, 32), (128, 128, 32))
LAYOUTS = ("nn", "nt", "tn")
GEMM_VARIANTS = {("nn", torch.bfloat16): SWEEP_TILES,
                 **{(lay, torch.float32): FORM_TILES for lay in LAYOUTS}}


def gemm_dims(a: torch.Tensor, b: torch.Tensor, layout: str) -> tuple:
    """(M, K, N) of ``op(a) @ op(b)``: "nn" a (M, K) b (K, N); "nt" a (M, K)
    b (N, K); "tn" a (K, M) b (K, N)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("tile_gemm takes 2-d operands")
    m, k = a.shape[::-1] if layout == "tn" else a.shape
    kb, n = b.shape[::-1] if layout == "nt" else b.shape
    if k != kb:
        raise ValueError(f"contracted dims differ: {k} vs {kb}")
    return m, k, n


def check_tile(m: int, k: int, n: int, tile, layout: str = "nn",
               out_dtype=torch.bfloat16) -> None:
    """Raise unless ``tile`` is a compiled K16 variant for ``layout`` and
    ``out_dtype`` and divides (M, K, N)."""
    tiles = GEMM_VARIANTS.get((layout, out_dtype))
    if tiles is None or tuple(tile) not in tiles:
        raise ValueError(f"no compiled tile_gemm variant {tuple(tile)} for "
                         f"layout {layout!r}, out {out_dtype}; have "
                         f"{tiles}")
    bm, bn, bk = tile
    if m % bm or n % bn or k % bk:
        raise ValueError(f"tiles {tuple(tile)} do not divide (M, K, N) = "
                         f"{(m, k, n)}")


def tile_gemm_plain(a: torch.Tensor, b: torch.Tensor, tile=(128, 128, 32),
                    layout: str = "nn",
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain twin of K16: the fp32 product of the bf16 operands in the given
    layout, rounded once to ``out_dtype``. Refuses what the kernel refuses."""
    m, k, n = gemm_dims(a, b, layout)
    check_tile(m, k, n, tile, layout, out_dtype)
    af, bf = a.float(), b.float()
    if layout == "tn":
        af = af.t()
    if layout == "nt":
        bf = bf.t()
    return (af @ bf).to(out_dtype)


# K16's persistent kernel (csrc/tile_gemm.cu `tg::Cfg`): the blocks an SM
# holds at a ring of GEMM_MIN_STAGES beside the output's staging, then as many
# stages as they leave room for, up to GEMM_MAX_STAGES; tiles walked in
# groups of GEMM_GROUP_M tile rows
GEMM_MIN_STAGES, GEMM_MAX_STAGES = 6, 8
GEMM_SMEM_LIMIT = 227 * 1024  # a block's shared memory
GEMM_SM_SMEM = 228 * 1024  # an SM's; 1 KB of it kept per block
GEMM_STATIC = 256  # room for the static mbarriers
GEMM_GROUP_M = 8


def tile_gemm_smem(tile, out_dtype=torch.bfloat16) -> tuple[int, int]:
    """(stages, dynamic shared memory) of a K16 block: the (BM x BK + BK x
    BN) bf16 stages of the ring, the (BM x BN) output staging and 1 KB of
    alignment. The blocks an SM holds at GEMM_MIN_STAGES stages (one if
    those do not fit a block) set the room; the ring takes as many stages
    of it as it can, up to GEMM_MAX_STAGES."""
    bm, bn, bk = tile
    stage = (bm * bk + bk * bn) * 2
    out = bm * bn * torch.empty((), dtype=out_dtype).element_size()
    blocks = max(1, GEMM_SM_SMEM // (GEMM_MIN_STAGES * stage + out + 1024
                                     + GEMM_STATIC + 1024))
    room = min(GEMM_SMEM_LIMIT - GEMM_STATIC,
               GEMM_SM_SMEM // blocks - GEMM_STATIC - 1024)
    stages = min(GEMM_MAX_STAGES, (room - out - 1024) // stage)
    return stages, stages * stage + out + 1024


def tile_gemm_blocks_per_sm(tile, out_dtype=torch.bfloat16) -> int:
    """K16's resident blocks an SM, by shared memory (the kernel's launch
    bounds ask the compiler for the registers to match)."""
    return GEMM_SM_SMEM // (tile_gemm_smem(tile, out_dtype)[1] + GEMM_STATIC
                            + 1024)


def tile_gemm_blocks(m: int, n: int, tile,
                     out_dtype=torch.bfloat16) -> int:
    """K16's persistent blocks: as many as the SMs hold, no more than the
    (M / BM) x (N / BN) tiles."""
    bm, bn, _ = tile
    return min((m // bm) * (n // bn),
               N_SMS * tile_gemm_blocks_per_sm(tile, out_dtype))


def tile_gemm_tile(i: int, m: int, n: int, bm: int, bn: int) -> tuple:
    """(first row, first column) of K16's tile ``i`` in the kernel's order:
    groups of GEMM_GROUP_M tile rows (fewer in the last group), each group
    walked down its rows before the next column of tiles."""
    mtn, ntn = m // bm, n // bn
    g, r = divmod(i, GEMM_GROUP_M * ntn)
    first = g * GEMM_GROUP_M
    gm = min(GEMM_GROUP_M, mtn - first)
    return (first + r % gm) * bm, (r // gm) * bn


def tile_gemm_schedule(m: int, n: int, bm: int, bn: int,
                       blocks: int) -> list[list[tuple]]:
    """The tiles each of K16's persistent blocks computes, in order: block b
    takes tiles b, b + G, b + 2G, ... of :func:`tile_gemm_tile`'s order, G the
    blocks, so the tiles in flight at once are neighbours in it."""
    tiles = (m // bm) * (n // bn)
    if not 1 <= blocks <= tiles:
        raise ValueError(f"blocks must lie in 1..{tiles}, got {blocks}")
    return [[tile_gemm_tile(i, m, n, bm, bn) for i in range(b, tiles, blocks)]
            for b in range(blocks)]


def _check_gemm(a, b, tile=(128, 128, 32), layout="nn",
                out_dtype=torch.bfloat16, variant=None) -> tuple:
    """K16's shape rules and its variant, on either device: (M, K, N)."""
    if variant not in (None, "wmma"):
        raise ValueError(f"unknown variant {variant!r}: None (the persistent "
                         f"kernel) or 'wmma'")
    m, k, n = gemm_dims(a, b, layout)
    check_tile(m, k, n, tile, layout, out_dtype)
    return m, k, n


def _launch_gemm(op, a, b, tile=(128, 128, 32), layout="nn",
                 out_dtype=torch.bfloat16, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"wmma"`` forces the
    kernel the persistent one replaced."""
    _build.require(a, "a", torch.bfloat16, 2)
    _build.require(b, "b", torch.bfloat16, 2)
    m, k, n = _check_gemm(a, b, tile, layout, out_dtype, variant)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, *tile,
            LAYOUTS.index(layout), int(out_dtype == torch.float32))
    name = f"{layout} {'x'.join(map(str, tile))} " \
           f"{str(out_dtype).split('.')[-1]}"
    if variant == "wmma":
        fn = _build.bind("tile_gemm", "acai_tile_gemm",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                         + [ctypes.c_void_p])
        rc = fn(*args, _build.stream_ptr())
        op.launched(f"{name} wmma")
    else:
        fn = _build.bind("tile_gemm", "acai_tile_gemm_persistent",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                         + [ctypes.c_void_p])
        rc = fn(*args, tile_gemm_blocks(m, n, tile, out_dtype),
                _build.stream_ptr())
        op.launched(name)
    _build.check(rc, op.name)
    return out


tile_gemm = _build.KernelOp(
    "tile_gemm", "acai_omr_tpu_torch/csrc/tile_gemm.cu",
    "tools/pallas_gemm_probe.py:23 (make_mm, pallas_call :39); "
    "tools/mosaic_dot_forms_probe.py:23 (make_kernel, pallas_call :37)",
    _launch_gemm, tile_gemm_plain, _check_gemm)


# ---------------------------------------------------------------------------
# single-query attention: K17, K18
# ---------------------------------------------------------------------------

HEADS = 16  # the block-diagonal operand is one m16 tile of heads
BLOCKDIAG_KEYS = (128, 256, 512, 1024)


def _check_attention(q, kT, vT, bias, bt: int) -> tuple:
    b, h, dh = q.shape
    t = kT.shape[-1]
    if kT.shape != (b, h, dh, t) or vT.shape != kT.shape:
        raise ValueError("q (B, H, Dh) and kT / vT (B, H, Dh, T) differ")
    if bias is not None and tuple(bias.shape) != (b, t):
        raise ValueError("bias must be (B, T)")
    if bt <= 0 or b % bt:
        raise ValueError(f"bt={bt} does not divide B={b}")
    return b, h, dh, t


def decode_attention_probe_plain(q: torch.Tensor, kT: torch.Tensor,
                                 vT: torch.Tensor,
                                 bias: torch.Tensor | None = None,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None,
                                 bt: int = 4) -> torch.Tensor:
    """Plain twin of K17 and K18, the JAX kernels' roundings: ``q . k`` of
    the bf16 values (int8 caches exact in bf16) summed in fp32, times
    1/sqrt(Dh), times ``k_scale`` (B, H, T) for int8, plus ``bias`` (B, T);
    a normalised fp32 softmax, times ``v_scale`` for int8; the weights
    rounded to bf16; the V sum in fp32, rounded to bf16."""
    _check_attention(q, kT, vT, bias, bt)
    logits = torch.einsum("bhd,bhdt->bht", q.float(), kT.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if k_scale is not None:
        logits = logits * k_scale
    if bias is not None:
        logits = logits + bias[:, None, :]
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        w = w * v_scale
    w = w.to(torch.bfloat16).float()
    return torch.einsum("bht,bhdt->bhd", w, vT.float()).to(torch.bfloat16)


BLOCKDIAG_UNIT = 16  # keys: a block's range is whole units
BLOCKDIAG_BOX = 64  # keys a TMA box: ranges of whole boxes read no key twice
BLOCKDIAG_MAX_SPLIT = 8  # a portable cluster
BLOCKDIAG_STAGE_BYTES = 16 * 1024  # a box, K or V
BLOCKDIAG_MIN_STAGES = 2
BLOCKDIAG_SMEM_LIMIT = 227 * 1024
BLOCKDIAG_STATIC = 2048  # csrc: room for the static shared memory
# what a cluster launch costs beyond an ordinary one (an H100 80GB HBM3 at
# 700 W: K13's 512 blocks 0.0130 ms with the cluster attribute, 0.0110
# without, PERF.md section 6)
BLOCKDIAG_CLUSTER_US = 2.0
HBM_BYTES_PER_S = 3.35e12


def blockdiag_ranges(t: int, split: int) -> list[tuple[int, int]]:
    """The key ranges [lo, hi) of a cluster's blocks, as the kernel forms
    them: block r owns units [r U / split, (r + 1) U / split) of the U =
    T / 16 units."""
    units = t // BLOCKDIAG_UNIT
    return [(r * units // split * BLOCKDIAG_UNIT,
             (r + 1) * units // split * BLOCKDIAG_UNIT) for r in range(split)]


def blockdiag_smem(chunk: int, dh: int, stages: int) -> int:
    """Dynamic shared memory of a K17 block at its smallest (csrc
    ``bd::Layout`` without the bias and scales, which the kernel copies in
    only where they fit and reads from device memory where not): the ring,
    the logits (fp32) and weights (bf16) of 16 heads over the range's key
    boxes, the row's q, its partial output and the peers' partials of the
    block's share, 1 KB of alignment."""
    keys = -(-chunk // BLOCKDIAG_BOX) * BLOCKDIAG_BOX
    return (stages * BLOCKDIAG_STAGE_BYTES + HEADS * (keys + 4) * 4
            + HEADS * (keys + 8) * 2 + HEADS * dh * 10 + 128 + 1024)


def _split_chunk(t: int, dh: int, split: int) -> tuple[int, int]:
    units = t // BLOCKDIAG_UNIT
    chunk = -(-units // split) * BLOCKDIAG_UNIT
    if blockdiag_smem(chunk, dh, BLOCKDIAG_MIN_STAGES) + BLOCKDIAG_STATIC \
            > BLOCKDIAG_SMEM_LIMIT:
        raise ValueError(f"{chunk} keys of head dim {dh} do not fit a "
                         f"block's shared memory")
    return chunk, split


def blockdiag_plan(b: int, t: int, dh: int,
                   int8: bool = False) -> tuple[int, int]:
    """(keys of a block's largest range, split) of K17's cluster kernel.

    One cluster of ``split`` blocks per row, whatever ``bt`` is; the T keys
    are U = T / 16 units and block r owns units [r U / split, (r + 1) U /
    split) (:func:`blockdiag_ranges`: in order, none empty). The kernel is a
    stream of K and V, so the split is the one whose estimate is least:
    the bytes its blocks' boxes read (a range that is not whole 64-key boxes
    reads the rest of its last box too) at 3.35 TB/s times the share of
    the 132 SMs the B x split blocks leave idle, plus BLOCKDIAG_CLUSTER_US
    for a cluster launch (split 1 is an ordinary launch); ties go to the
    smaller split. At B = 32, T = 512 that is split 8: 256 blocks, where
    ``bt`` gave the TPU's kernel 4-16."""
    units = t // BLOCKDIAG_UNIT
    per_key = 2 * HEADS * dh * (1 if int8 else 2) + (2 * HEADS * 4 if int8
                                                      else 0)
    best = None
    for split in range(1, min(BLOCKDIAG_MAX_SPLIT, units) + 1):
        boxed = sum(-(-(hi - lo) // BLOCKDIAG_BOX) * BLOCKDIAG_BOX
                    for lo, hi in blockdiag_ranges(t, split))
        busy = min(1.0, b * split / N_SMS)
        us = 1e6 * b * boxed * per_key / HBM_BYTES_PER_S / busy \
            + (BLOCKDIAG_CLUSTER_US if split > 1 else 0.0)
        if best is None or us < best[0] - 1e-9:
            best = (us, split)
    return _split_chunk(t, dh, best[1])


def blockdiag_split(variant, b: int, t: int, dh: int, int8: bool = False):
    """(keys of the largest range, split) of a K17 call: the plan's, or
    ``variant`` ``"split{s}"`` forced (fewer blocks where T has fewer units
    than s); None for ``"wmma"``. Raises ValueError on an unknown variant."""
    if variant is None:
        return blockdiag_plan(b, t, dh, int8)
    if variant == "wmma":
        return None
    s = variant[5:] if isinstance(variant, str) \
        and variant.startswith("split") else ""
    if not (s.isdigit() and 1 <= int(s) <= BLOCKDIAG_MAX_SPLIT):
        raise ValueError(f"unknown variant {variant!r}: 'wmma' or 'split1' "
                         f".. 'split{BLOCKDIAG_MAX_SPLIT}'")
    return _split_chunk(t, dh, min(int(s), t // BLOCKDIAG_UNIT))


def blockdiag_decode_attention_plain(q, kT, vT, bias=None, k_scale=None,
                                     v_scale=None, bt: int = 4):
    """Plain twin of K17 (:func:`decode_attention_probe_plain`); the output
    does not depend on ``bt``."""
    _check_blockdiag(q, kT, k_scale, v_scale)
    return decode_attention_probe_plain(q, kT, vT, bias, k_scale, v_scale, bt)


def _check_blockdiag(q, kT, k_scale, v_scale) -> None:
    b, h, dh = q.shape
    t = kT.shape[-1]
    if h != HEADS or dh % 16 or t not in BLOCKDIAG_KEYS:
        raise ValueError(f"blockdiag attention takes H = {HEADS}, Dh % 16 == 0"
                         f", T in {BLOCKDIAG_KEYS}; got {(h, dh, t)}")
    if (kT.dtype == torch.int8) != (k_scale is not None) \
            or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 caches take k_scale and v_scale, bf16 none")
    if k_scale is not None and (tuple(k_scale.shape) != (b, h, t)
                                or tuple(v_scale.shape) != (b, h, t)):
        raise ValueError("k_scale / v_scale must be (B, H, T)")


def _check_blockdiag_call(q, kT, vT, bias=None, k_scale=None, v_scale=None,
                          bt: int = 4, variant=None):
    """K17's shape rules and its variant, on either device: the plan (keys
    a block, split), or None for ``"wmma"``."""
    b, _, dh, t = _check_attention(q, kT, vT, bias, bt)
    _check_blockdiag(q, kT, k_scale, v_scale)
    return blockdiag_split(variant, b, t, dh, kT.dtype == torch.int8)


def _launch_blockdiag(op, q, kT, vT, bias=None, k_scale=None, v_scale=None,
                      bt: int = 4, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"split{s}"`` forces
    the cluster kernel's split, ``"wmma"`` the kernel it replaced."""
    plan = _check_blockdiag_call(q, kT, vT, bias, k_scale, v_scale, bt,
                                 variant)
    int8 = kT.dtype == torch.int8
    _build.require(q, "q", torch.bfloat16, 3)
    for name, a in (("kT", kT), ("vT", vT)):
        _build.require(a, name, torch.int8 if int8 else torch.bfloat16, 4)
    b, _, dh, t = kT.shape
    for name, a in (("bias", bias), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if a is not None:
            _build.require(a, name, torch.float32, a.dim())
    out = torch.empty_like(q)
    ptr = lambda x: 0 if x is None else x.data_ptr()
    args = (q.data_ptr(), kT.data_ptr(), vT.data_ptr(), ptr(bias),
            ptr(k_scale), ptr(v_scale), int(int8))
    cache = "int8" if int8 else "bf16"
    if plan is None:
        fn = _build.bind("probe_decode_attention",
                         "acai_blockdiag_decode_attention",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                         + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, b, bt, dh, t, 1.0 / math.sqrt(dh), out.data_ptr(),
                _build.stream_ptr())
        op.launched(f"{cache} bt={bt} wmma")
    else:
        chunk, split = plan
        fn = _build.bind("probe_decode_attention",
                         "acai_blockdiag_decode_attention_cluster",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                         + [ctypes.c_float] + [ctypes.c_int] * 2
                         + [ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*args, b, dh, t, 1.0 / math.sqrt(dh), chunk, split,
                out.data_ptr(), _build.stream_ptr())
        op.launched(f"{cache} bt={bt} split{split}")
    _build.check(rc, op.name)
    return out


blockdiag_decode_attention = _build.KernelOp(
    "blockdiag_decode_attention",
    "acai_omr_tpu_torch/csrc/probe_decode_attention.cu",
    "tools/attn_microbench.py:89 (_blockdiag_kernel via blockdiag_attn :129, "
    "pallas_call :151)", _launch_blockdiag, blockdiag_decode_attention_plain,
    _check_blockdiag_call)


BATCHED_GROUP = 8  # K18: keys a lane, one 16-byte load of bf16


def batched_route(t: int, aligned: bool = True) -> str:
    """How K18's kernel loads (csrc/probe_decode_attention.cu
    `acai_batched_decode_attention_rowhead`): ``"vector"``, 8 keys of a row
    in one 16-byte load (T % 8 == 0, the planes 16-byte aligned), else
    ``"scalar"``, one load a key."""
    return "vector" if aligned and t % BATCHED_GROUP == 0 else "scalar"


def batched_decode_attention_plain(q, kT, vT, bias=None, bt: int = 4):
    return decode_attention_probe_plain(q, kT, vT, bias, bt=bt)


def _check_batched(q, kT, vT, bias=None, bt: int = 4, variant=None) -> tuple:
    """K18's shape rules and its variant, on either device: (B, H, Dh, T).
    ``bt`` keeps only the TPU kernel's rule, B % bt == 0."""
    if variant not in (None, "warp"):
        raise ValueError(f"unknown variant {variant!r}: None (one block per "
                         f"(row, head)) or 'warp'")
    b, h, dh, t = _check_attention(q, kT, vT, bias, bt)
    if h != HEADS:
        raise ValueError(f"batched attention takes H = {HEADS}, got {h}")
    return b, h, dh, t


def _launch_batched(op, q, kT, vT, bias=None, bt: int = 4, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"warp"`` forces the
    kernel this one replaced (one warp per (row, head), B / bt blocks)."""
    _build.require(q, "q", torch.bfloat16, 3)
    _build.require(kT, "kT", torch.bfloat16, 4)
    _build.require(vT, "vT", torch.bfloat16, 4)
    b, h, dh, t = _check_batched(q, kT, vT, bias, bt, variant)
    if bias is not None:
        _build.require(bias, "bias", torch.float32, 2)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), kT.data_ptr(), vT.data_ptr(),
            0 if bias is None else bias.data_ptr())
    if variant == "warp":
        fn = _build.bind("probe_decode_attention",
                         "acai_batched_decode_attention",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                         + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        rc = fn(*ptrs, b, bt, dh, t, 1.0 / math.sqrt(dh), out.data_ptr(),
                _build.stream_ptr())
        op.launched(f"bt={bt} warp")
    else:
        route = batched_route(t, kT.data_ptr() % 16 == 0
                              and vT.data_ptr() % 16 == 0)
        fn = _build.bind("probe_decode_attention",
                         "acai_batched_decode_attention_rowhead",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_void_p])
        rc = fn(*ptrs, b, dh, t, 1.0 / math.sqrt(dh), int(route == "vector"),
                out.data_ptr(), _build.stream_ptr())
        op.launched(f"bt={bt} {route}")
    _build.check(rc, op.name)
    return out


batched_decode_attention = _build.KernelOp(
    "batched_decode_attention",
    "acai_omr_tpu_torch/csrc/probe_decode_attention.cu",
    "tools/attn_microbench.py:157 (_batcheddot_kernel via batcheddot_attn "
    ":176, pallas_call :184)", _launch_batched, batched_decode_attention_plain,
    _check_batched)


# ---------------------------------------------------------------------------
# scratch capacity: K19
# ---------------------------------------------------------------------------

SMEM_ROW_BYTES = 128 * 2  # one (128,) bf16 row of the scratch
# None: the warp kernel; "simple": the kernel it replaced
SMEM_VARIANTS = (None, "simple")


class SmemRefused(RuntimeError):
    """The card refused K19's scratch size: the probe's expected answer past
    the limit. ``code`` is the CUDA error."""

    def __init__(self, n_bytes: int, code: int, text: str):
        super().__init__(f"{n_bytes} bytes of shared memory refused: CUDA "
                         f"error {code} ({text})")
        self.n_bytes, self.code = n_bytes, code


def _check_smem(x: torch.Tensor, n_bytes: int, variant=None) -> None:
    """K19's shape rules and its variant, on either device."""
    if variant not in SMEM_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: None (the warp "
                         f"kernel) or 'simple'")
    if tuple(x.shape) != (8, 128) or x.dtype != torch.bfloat16:
        raise ValueError("x must be (8, 128) bf16")
    if n_bytes < 8 * SMEM_ROW_BYTES or n_bytes % SMEM_ROW_BYTES:
        raise ValueError(f"scratch of {n_bytes} bytes: whole 256-byte rows, "
                         f"at least 8")


def smem_probe_plain(x: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """Plain twin of K19: row 0 of ``x`` into row 0 of an (n_bytes / 256,
    128) bf16 scratch, out = scratch[0:8] * 2. The scratch's other rows are
    zeros here; the kernel's are whatever the card held (only row 0 is
    defined on the card, as on the TPU)."""
    _check_smem(x, n_bytes)
    scratch = torch.zeros((n_bytes // SMEM_ROW_BYTES, 128), dtype=x.dtype,
                          device=x.device)
    scratch[0] = x[0]
    return scratch[0:8] * 2.0


def _smem_lib():
    lib = _build.library("smem_probe")
    lib.acai_cuda_error_string.argtypes = [ctypes.c_int]
    lib.acai_cuda_error_string.restype = ctypes.c_char_p
    return lib


# the largest dynamic shared memory the warp kernel may ask for on each
# device: its attribute is set only for a size past it, so a call that
# launches is one launch; a refused size leaves it as it was
_SMEM_SET: dict[int, int] = {}
_SMEM_LOCK = threading.Lock()


def _refused(n_bytes: int, rc: int) -> SmemRefused:
    return SmemRefused(n_bytes, rc,
                       _smem_lib().acai_cuda_error_string(rc).decode())


def smem_set_max(device_index: int, n_bytes: int) -> None:
    """Let a launch of K19's warp kernel on device ``device_index`` ask for
    ``n_bytes`` of dynamic shared memory: ``cudaFuncSetAttribute`` only when
    ``n_bytes`` is past the largest set there so far. A refusal raises
    :class:`SmemRefused` and leaves the cache as it was."""
    if n_bytes <= _SMEM_SET.get(device_index, 0):
        return
    with _SMEM_LOCK:
        if n_bytes <= _SMEM_SET.get(device_index, 0):
            return
        fn = _build.bind("smem_probe", "acai_smem_set_max",
                         [ctypes.c_int, ctypes.c_int])
        rc = fn(n_bytes, 0)
        if rc != 0:
            raise _refused(n_bytes, rc)
        _SMEM_SET[device_index] = n_bytes


def _launch_smem(op, x, n_bytes: int, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"simple"`` forces
    the kernel the warp kernel replaced, launched as it was (an ordinary
    launch, its attribute set on every call)."""
    _build.require(x, "x", torch.bfloat16, 2)
    _check_smem(x, n_bytes, variant)
    out = torch.empty_like(x)
    ptr = x.data_ptr()
    if variant == "simple":
        fn = _build.bind("smem_probe", "acai_smem_probe_simple",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p])
        rc = fn(ptr, out.data_ptr(), n_bytes, _build.stream_ptr())
    else:
        if ptr % 8:
            raise ValueError("x must be 8-byte aligned: a lane loads 8 bytes")
        smem_set_max(x.get_device(), n_bytes)
        fn = _build.bind("smem_probe", "acai_smem_probe",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p])
        rc = fn(ptr, out.data_ptr(), n_bytes, _build.stream_ptr())
    if rc != 0:  # refused: nothing launched
        raise _refused(n_bytes, rc)
    op.launched(f"{n_bytes // 1024} KB{' simple' if variant else ''}")
    return out


smem_probe = _build.KernelOp(
    "smem_probe", "acai_omr_tpu_torch/csrc/smem_probe.cu",
    "tools/vmem_probe.py:13 (probe, pallas_call :21)", _launch_smem,
    smem_probe_plain, _check_smem)


def smem_graph_edges(x: torch.Tensor, n_bytes: int,
                     n: int = 20) -> tuple[int, int]:
    """(edges, programmatic edges) of a CUDA graph captured from ``n``
    launches of K19's warp kernel on ``x``: whether the graph keeps the
    overlap of a programmatic launch. Not counted as launches."""
    _build.require(x, "x", torch.bfloat16, 2)
    _check_smem(x, n_bytes)
    smem_set_max(x.get_device(), n_bytes)
    out = torch.empty_like(x)
    edges, prog = ctypes.c_int(0), ctypes.c_int(0)
    fn = _build.bind("smem_probe", "acai_smem_graph_edges",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    _build.check(fn(x.data_ptr(), out.data_ptr(), n_bytes, n,
                    ctypes.addressof(edges), ctypes.addressof(prog)),
                 "acai_smem_graph_edges")
    return edges.value, prog.value


def smem_optin_bytes() -> int:
    """cudaDevAttrMaxSharedMemoryPerBlockOptin of the current CUDA device."""
    val = ctypes.c_int(0)
    fn = _build.bind("smem_probe", "acai_smem_optin",
                     [ctypes.POINTER(ctypes.c_int)])
    _build.check(fn(ctypes.byref(val)), "acai_smem_optin")
    return val.value
