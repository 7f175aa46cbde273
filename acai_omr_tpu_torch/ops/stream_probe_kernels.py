"""The kernels of the memory-stream probes: K22 :data:`bulk_copy_ring`, K23
:data:`clamped_chunk_sum` and K24 :data:`lane_stream_sum`
(``csrc/stream_probe.cu``).

Port of the Pallas kernels of ``tools/dma_issue_probe.py`` (``build``),
``tools/dma_skip_probe.py`` (``run``) and ``tools/narrow_lane_dma_probe.py``
(``stream_sum``), which ask what a copy costs to issue, whether reads past a
device-side length cost memory traffic, and whether narrow rows stream at the
rate of wide ones. Each has its plain PyTorch twin beside it.

K23 walks the chunks as the TPU's grid does, one block a tile
(:func:`chunk_tiles`), and copies a chunk only where :func:`chunk_walk` says
the Pallas pipeline would: where the step adds it and its index changed.
``variant="grid"`` forces the two-launch kernel it replaced, kept as the
yardstick.

K24 sums the stream in one launch: a persistent grid walks it with the
next step's sixteen 16-byte loads in flight a thread while it adds the step
before (:func:`stream_plan`, :func:`stream_walk`), and the last block to
take a ticket adds the blocks' partial rows;
``variant="two_pass"`` forces the two-launch form it replaced.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .linear_kernel import N_SMS

LANES = 1024  # bf16 lanes of one source row of K22, as the TPU tool's
ROW_BYTES = LANES * 2
MAX_SLOTS = 8
EXPECT_TX_MAX = 2 ** 20 - 1  # bytes one mbarrier phase may expect
HOPPER_SMEM_OPTIN = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin, H100
RING_STATIC_SMEM = 8 * MAX_SLOTS  # the barriers
CHUNK_SLICES = 8  # K23's grid form: row slices of a chunk (x E / 128 strips)
STRIP = 128  # K23: columns of a tile
WALK_TARGET_BLOCKS = 2 * N_SMS  # K23's walk: two blocks an SM
WALK_RING_BYTES = 96 * 1024  # a walk block's ring, two blocks an SM
WALK_ROWS = (16, 128)  # the rows of a walk tile, a power of two between
WALK_MAX_SLOTS = 4
CHUNK_VARIANTS = (None, "grid")
MAX_STREAM_BLOCKS = 512  # blocks of the two-pass form K24 replaced


# ---------------------------------------------------------------------------
# K22: the bulk-copy ring
# ---------------------------------------------------------------------------

def ring_plan(src: torch.Tensor, slots: int, frags: int, blocks: int,
              smem_limit: int = HOPPER_SMEM_OPTIN) -> tuple[int, int]:
    """(steps, slot bytes) of a K22 call on ``src`` (steps, rows, 1024)
    bf16, each of ``blocks`` blocks streaming rows / blocks rows a step.
    Raises on what the kernel does not take: fewer than 8 rows a block,
    ``slots`` outside 2..8, a fragment that is not a multiple of 16 bytes,
    a slot past ``expect_tx``'s 2^20 - 1 bytes, or slots x slot past
    ``smem_limit``."""
    if src.dim() != 3 or src.shape[2] != LANES or src.dtype != torch.bfloat16:
        raise ValueError(f"src must be (steps, rows, {LANES}) bf16")
    steps, rows, _ = src.shape
    if blocks < 1 or rows % blocks or rows // blocks < 8:
        raise ValueError(f"rows={rows} must split into {blocks} blocks of at "
                         f"least 8 rows")
    if not 2 <= slots <= MAX_SLOTS:
        raise ValueError(f"slots must be 2..{MAX_SLOTS}, got {slots}")
    slot = rows // blocks * ROW_BYTES
    if frags < 1 or slot % (16 * frags):
        raise ValueError(f"a slot of {slot} bytes in {frags} fragments: each "
                         f"must be a multiple of 16 bytes")
    if slot > EXPECT_TX_MAX:
        raise ValueError(f"a slot of {slot} bytes is past expect_tx's "
                         f"{EXPECT_TX_MAX}")
    if slots * slot + RING_STATIC_SMEM > smem_limit:
        raise ValueError(f"{slots} slots of {slot} bytes are past the "
                         f"{smem_limit} bytes of shared memory a block may "
                         f"hold")
    return steps, slot


def bulk_copy_ring_plain(src: torch.Tensor, slots: int = 3, frags: int = 1,
                         blocks: int = 1) -> torch.Tensor:
    """Plain twin of K22: rows 0..7, lanes 0..127 of the last step (the
    first fragment's tile)."""
    ring_plan(src, slots, frags, blocks)
    return src[-1, :8, :128].clone()


def _launch_ring(op, src, slots=3, frags=1, blocks=1):
    from .probe_kernels import smem_optin_bytes
    _build.require(src, "src", torch.bfloat16, 3)
    steps, slot = ring_plan(src, slots, frags, blocks, smem_optin_bytes())
    if src.data_ptr() % 16:
        raise ValueError("src must be 16-byte aligned")
    out = torch.empty((8, 128), dtype=torch.bfloat16, device=src.device)
    fn = _build.bind("stream_probe", "acai_bulk_copy_ring",
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])
    rc = fn(src.data_ptr(), out.data_ptr(), steps, blocks, slots, frags, slot,
            ROW_BYTES, _build.stream_ptr())
    op.launched(f"F={frags}")
    _build.check(rc, op.name)
    return out


bulk_copy_ring = _build.KernelOp(
    "bulk_copy_ring", "acai_omr_tpu_torch/csrc/stream_probe.cu",
    "tools/dma_issue_probe.py:66 (build, _kernel :34, pallas_call :77)",
    _launch_ring, bulk_copy_ring_plain)


# ---------------------------------------------------------------------------
# K23: clamped chunk sums
# ---------------------------------------------------------------------------

MODES = ("clamped", "skip")


def chunk_tiles(ch: int, e: int) -> tuple[int, int, int, int]:
    """(rows, slices, strips, slots) of K23's walk over chunks of (ch, e):
    tiles of ``rows`` rows (the fewest, a power of two in 16..128, that keep
    the grid within two blocks an SM) x 128 columns, ``slices`` =
    ceil(ch / rows) row slices (the last one's rows past ch read as zeros)
    x ``strips`` = e / 128, one block a tile; a ring of ``slots`` tiles
    (2..4, within 96 KB so that two blocks share an SM)."""
    strips = e // STRIP
    rows = WALK_ROWS[0]
    while rows < WALK_ROWS[1] and -(-ch // rows) * strips > WALK_TARGET_BLOCKS:
        rows *= 2
    slots = max(2, min(WALK_MAX_SLOTS, WALK_RING_BYTES // (rows * STRIP * 2)))
    return rows, -(-ch // rows), strips, slots


def walk_copies(k: int, s: int) -> bool:
    """Whether step k of K23's walk copies chunk min(k, s): k <= s and the
    index changed since step k - 1's min(k - 1, s) (none before step 0).
    The rule needs no state, so the kernel's lanes decide 32 steps at once
    (``csrc/stream_probe.cu`` ``walk_copies``)."""
    return k <= s and min(k, s) != (min(k - 1, s) if k else -1)


def chunk_walk(n: int, s: int, mode: str = "clamped") -> list[tuple]:
    """The steps a K23 block walks: (k, c, copy, add) for k = 0 .. n - 1
    (``skip``: to min(s, n - 1)), c = min(k, s) the chunk the TPU's index
    map asks for, ``copy`` whether the block copies it
    (:func:`walk_copies`), ``add`` whether the TPU kernel adds it (k <= s).
    The kernel adds a tile where it copies one."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    steps = n if mode == "clamped" else max(0, min(s, n - 1) + 1)
    return [(k, min(k, s), walk_copies(k, s), k <= s) for k in range(steps)]


def _check_chunks(x: torch.Tensor, s: torch.Tensor, mode: str = "clamped",
                  variant=None) -> int:
    """K23's shape rules and its variant, on either device: the grid form's
    row slices of a chunk."""
    if variant not in CHUNK_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: None (the walk) or "
                         f"'grid'")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise ValueError("x must be (chunks, rows, E) bf16")
    _, ch, e = x.shape
    if e % STRIP or e == 0:
        raise ValueError(f"E must be a positive multiple of {STRIP}, got {e}")
    if s.numel() != 1 or s.dtype != torch.int32 or s.device != x.device:
        raise ValueError("s must be one int32 on x's device")
    return next(d for d in range(min(CHUNK_SLICES, ch), 0, -1) if ch % d == 0)


def clamped_chunk_sum_plain(x: torch.Tensor, s: torch.Tensor,
                            mode: str = "clamped") -> torch.Tensor:
    """Plain twin of K23: the fp32 column sums of chunks 0..s, (1, E)."""
    _check_chunks(x, s, mode)
    last = min(max(int(s.reshape(-1)[0]), -1), x.shape[0] - 1)
    return x[: last + 1].float().sum(dim=(0, 1)).reshape(1, -1)


# K23's scratch by (device, slices, E): the tiles' partial rows and the
# strips' tickets, allocated once (the kernel leaves the tickets zero). Calls
# that share a shape run on one stream at a time.
_WALK_SCRATCH: dict = {}


def _walk_scratch(device, slices: int, e: int) -> tuple:
    key = (device, slices, e)
    got = _WALK_SCRATCH.get(key)
    if got is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("clamped_chunk_sum: call it once outside a "
                               "CUDA graph capture first (its scratch)")
        got = (torch.empty((slices, e), dtype=torch.float32, device=device),
               torch.zeros(e // STRIP, dtype=torch.int32, device=device))
        _WALK_SCRATCH[key] = got
    return got


def _launch_chunks(op, x, s, mode="clamped", variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"grid"`` forces the
    two-launch kernel this one replaced."""
    grid_slices = _check_chunks(x, s, mode, variant)
    _build.require(x, "x", torch.bfloat16, 3)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    n, ch, e = x.shape
    out = torch.empty((1, e), dtype=torch.float32, device=x.device)
    if variant == "grid":
        partial = torch.empty((n * grid_slices, e), dtype=torch.float32,
                              device=x.device)
        fn = _build.bind("stream_probe", "acai_clamped_chunk_sum",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
        rc = fn(x.data_ptr(), s.data_ptr(), partial.data_ptr(),
                out.data_ptr(), n, ch, e, grid_slices, int(mode == "skip"),
                _build.stream_ptr())
        op.launched(f"{mode} grid")
        op.extra_launches += 1  # the second pass over the partial rows
    else:
        rows, slices, _, slots = chunk_tiles(ch, e)
        partial, tickets = _walk_scratch(x.device, slices, e)
        fn = _build.bind("stream_probe", "acai_clamped_chunk_walk",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p])
        rc = fn(x.data_ptr(), s.data_ptr(), partial.data_ptr(),
                tickets.data_ptr(), out.data_ptr(), n, ch, e, rows, slices,
                slots, int(mode == "skip"), _build.stream_ptr())
        op.launched(mode)
    _build.check(rc, op.name)
    return out


clamped_chunk_sum = _build.KernelOp(
    "clamped_chunk_sum", "acai_omr_tpu_torch/csrc/stream_probe.cu",
    "tools/dma_skip_probe.py:44 (run, kernel :28, pallas_call :55)",
    _launch_chunks, clamped_chunk_sum_plain, _check_chunks)


# ---------------------------------------------------------------------------
# K24: lane sums of a flat stream
# ---------------------------------------------------------------------------

STREAM_THREADS = 256  # K24's block
STREAM_VEC = 16  # float4 loads a thread issues a step (the next step's too)
STREAM_BLOCKS_PER_SM = 1
STREAM_VARIANTS = (None, "two_pass")


def stream_plan(x: torch.Tensor, c: torch.Tensor) -> tuple[int, int, int]:
    """(lanes, blocks, float4s a thread a step) of a K24 call: a persistent
    grid of at most one 256-thread block an SM, each thread issuing a
    step's sixteen 16-byte loads before it adds the step before
    (:func:`stream_walk`); fewer blocks where the stream is shorter than one
    step of the full grid. Raises on what the kernel does not take."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError("x must be (blocks, T, lanes) fp32")
    lanes = x.shape[2]
    if lanes < 4 or lanes > 256 or 1024 % lanes:
        raise ValueError(f"lanes must divide 1024 and lie in 4..256, got "
                         f"{lanes}")
    if tuple(c.shape) != (1, lanes) or c.dtype != torch.float32:
        raise ValueError(f"c must be (1, {lanes}) fp32")
    n = x.numel()
    if n % 1024 or n == 0:
        raise ValueError(f"x must hold a multiple of 1024 values, got {n}")
    per_block = STREAM_THREADS * STREAM_VEC
    blocks = min(-(-(n // 4) // per_block), STREAM_BLOCKS_PER_SM * N_SMS)
    return lanes, blocks, STREAM_VEC


def stream_walk(n4: int, blocks: int, vec: int = STREAM_VEC) -> torch.Tensor:
    """The float4 indices of a flat stream of ``n4`` float4s that K24's
    threads load (``csrc/stream_probe.cu`` ``lane_sum_kernel``), -1 where a
    load is past the end: (steps, vec, blocks x 256), thread g's j-th load
    of a step at g + j x (the grid's threads) + the step's start, the steps
    vec x the grid's threads apart."""
    threads = blocks * STREAM_THREADS
    step = threads * vec
    steps = -(-n4 // step)
    idx = (torch.arange(steps, dtype=torch.int64)[:, None, None] * step
           + torch.arange(vec, dtype=torch.int64)[None, :, None] * threads
           + torch.arange(threads, dtype=torch.int64)[None, None, :])
    return torch.where(idx < n4, idx, torch.full_like(idx, -1))


def two_pass_plan(n: int) -> tuple[int, int]:
    """(blocks, float4s a block) of the two-pass form K24 replaced: the
    most blocks up to 512 that split the stream's 1024-value units evenly."""
    units = n // 1024
    blocks = next(d for d in range(min(MAX_STREAM_BLOCKS, units), 0, -1)
                  if units % d == 0)
    return blocks, n // 4 // blocks


def lane_stream_sum_plain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain twin of K24: ``c + x.sum((0, 1))`` in fp32, (1, lanes)."""
    stream_plan(x, c)
    return c + x.sum(dim=(0, 1)).reshape(1, -1)


def _check_stream(x: torch.Tensor, c: torch.Tensor, variant=None) -> None:
    """K24's shape rules and its variant, on either device."""
    if variant not in STREAM_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: None (one launch) or "
                         f"'two_pass'")
    stream_plan(x, c)


# K24's scratch by (device, blocks, lanes): the blocks' partial rows and the
# ticket, allocated once (the kernel leaves the ticket zero). Calls that
# share a shape run on one stream at a time.
_STREAM_SCRATCH: dict = {}


def _stream_scratch(device, blocks: int, lanes: int) -> tuple:
    key = (device, blocks, lanes)
    got = _STREAM_SCRATCH.get(key)
    if got is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("lane_stream_sum: call it once outside a CUDA "
                               "graph capture first (its scratch)")
        got = (torch.empty((blocks, lanes), dtype=torch.float32,
                           device=device),
               torch.zeros(1, dtype=torch.int32, device=device))
        _STREAM_SCRATCH[key] = got
    return got


def _launch_stream(op, x, c, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"two_pass"`` forces
    the two-launch form this kernel replaced."""
    _check_stream(x, c, variant)
    lanes, blocks, _ = stream_plan(x, c)
    _build.require(x, "x", torch.float32, 3)
    _build.require(c, "c", torch.float32, 2)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if c.device != x.device:
        raise ValueError("x and c must be on one device")
    out = torch.empty((1, lanes), dtype=torch.float32, device=x.device)
    if variant == "two_pass":
        blocks, per_block = two_pass_plan(x.numel())
        partial = torch.empty((blocks, lanes), dtype=torch.float32,
                              device=x.device)
        fn = _build.bind("stream_probe", "acai_lane_stream_sum_two_pass",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
        rc = fn(x.data_ptr(), c.data_ptr(), partial.data_ptr(),
                out.data_ptr(), blocks, per_block, lanes, _build.stream_ptr())
        op.launched(f"lanes={lanes} two_pass")
        op.extra_launches += 1  # the second pass over the blocks' rows
    else:
        partial, ticket = _stream_scratch(x.device, blocks, lanes)
        fn = _build.bind("stream_probe", "acai_lane_stream_sum",
                         [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                         + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        rc = fn(x.data_ptr(), c.data_ptr(), partial.data_ptr(),
                ticket.data_ptr(), out.data_ptr(), x.numel() // 4, blocks,
                lanes, _build.stream_ptr())
        op.launched(f"lanes={lanes}")
    _build.check(rc, op.name)
    return out


lane_stream_sum = _build.KernelOp(
    "lane_stream_sum", "acai_omr_tpu_torch/csrc/stream_probe.cu",
    "tools/narrow_lane_dma_probe.py:25 (stream_sum, pallas_call :36)",
    _launch_stream, lane_stream_sum_plain, _check_stream)
