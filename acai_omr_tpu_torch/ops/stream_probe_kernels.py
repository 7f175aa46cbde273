"""The kernels of the memory-stream probes: K22 :data:`bulk_copy_ring`, K23
:data:`clamped_chunk_sum` and K24 :data:`lane_stream_sum`
(``csrc/stream_probe.cu``).

Port of the Pallas kernels of ``tools/dma_issue_probe.py`` (``build``),
``tools/dma_skip_probe.py`` (``run``) and ``tools/narrow_lane_dma_probe.py``
(``stream_sum``), which ask what a copy costs to issue, whether reads past a
device-side length cost memory traffic, and whether narrow rows stream at the
rate of wide ones. Each has its plain PyTorch twin beside it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LANES = 1024  # bf16 lanes of one source row of K22, as the TPU tool's
ROW_BYTES = LANES * 2
MAX_SLOTS = 8
EXPECT_TX_MAX = 2 ** 20 - 1  # bytes one mbarrier phase may expect
HOPPER_SMEM_OPTIN = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin, H100
RING_STATIC_SMEM = 8 * MAX_SLOTS  # the barriers
CHUNK_SLICES = 8  # K23 row slices of a chunk (x E / 128 strips)
MAX_STREAM_BLOCKS = 512  # K24 blocks


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


def _check_chunks(x: torch.Tensor, s: torch.Tensor, mode: str) -> int:
    """K23's blocks per chunk; raises on what the kernel does not take."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise ValueError("x must be (chunks, rows, E) bf16")
    _, ch, e = x.shape
    if e % 128 or e == 0:
        raise ValueError(f"E must be a positive multiple of 128, got {e}")
    if s.numel() != 1 or s.dtype != torch.int32 or s.device != x.device:
        raise ValueError("s must be one int32 on x's device")
    return next(d for d in range(min(CHUNK_SLICES, ch), 0, -1) if ch % d == 0)


def clamped_chunk_sum_plain(x: torch.Tensor, s: torch.Tensor,
                            mode: str = "clamped") -> torch.Tensor:
    """Plain twin of K23: the fp32 column sums of chunks 0..s, (1, E)."""
    _check_chunks(x, s, mode)
    last = min(max(int(s.reshape(-1)[0]), -1), x.shape[0] - 1)
    return x[: last + 1].float().sum(dim=(0, 1)).reshape(1, -1)


def _launch_chunks(op, x, s, mode="clamped"):
    slices = _check_chunks(x, s, mode)
    _build.require(x, "x", torch.bfloat16, 3)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    n, ch, e = x.shape
    partial = torch.empty((n * slices, e), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((1, e), dtype=torch.float32, device=x.device)
    fn = _build.bind("stream_probe", "acai_clamped_chunk_sum",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), s.data_ptr(), partial.data_ptr(), out.data_ptr(), n,
            ch, e, slices, int(mode == "skip"), _build.stream_ptr())
    op.launched(mode)
    op.extra_launches += 1  # the second pass over the partial rows
    _build.check(rc, op.name)
    return out


clamped_chunk_sum = _build.KernelOp(
    "clamped_chunk_sum", "acai_omr_tpu_torch/csrc/stream_probe.cu",
    "tools/dma_skip_probe.py:44 (run, kernel :28, pallas_call :55)",
    _launch_chunks, clamped_chunk_sum_plain)


# ---------------------------------------------------------------------------
# K24: lane sums of a flat stream
# ---------------------------------------------------------------------------

def stream_plan(x: torch.Tensor, c: torch.Tensor) -> tuple[int, int, int]:
    """(lanes, blocks, float4s a block) of a K24 call; raises on what the
    kernel does not take."""
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
    units = n // 1024
    blocks = next(d for d in range(min(MAX_STREAM_BLOCKS, units), 0, -1)
                  if units % d == 0)
    return lanes, blocks, n // 4 // blocks


def lane_stream_sum_plain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain twin of K24: ``c + x.sum((0, 1))`` in fp32, (1, lanes)."""
    stream_plan(x, c)
    return c + x.sum(dim=(0, 1)).reshape(1, -1)


def _launch_stream(op, x, c):
    lanes, blocks, per_block = stream_plan(x, c)
    _build.require(x, "x", torch.float32, 3)
    _build.require(c, "c", torch.float32, 2)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    partial = torch.empty((blocks, lanes), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((1, lanes), dtype=torch.float32, device=x.device)
    fn = _build.bind("stream_probe", "acai_lane_stream_sum",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), c.data_ptr(), partial.data_ptr(), out.data_ptr(),
            blocks, per_block, lanes, _build.stream_ptr())
    op.launched(f"lanes={lanes}")
    op.extra_launches += 1  # the second pass over the blocks' rows
    _build.check(rc, op.name)
    return out


lane_stream_sum = _build.KernelOp(
    "lane_stream_sum", "acai_omr_tpu_torch/csrc/stream_probe.cu",
    "tools/narrow_lane_dma_probe.py:25 (stream_sum, pallas_call :36)",
    _launch_stream, lane_stream_sum_plain)
