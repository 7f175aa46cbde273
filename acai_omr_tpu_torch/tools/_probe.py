"""What the probe tools share: the device they run on, its name, the card's
peaks, and a timer that can time from HBM."""

from __future__ import annotations

import math
import subprocess
import time

import torch

# the card's published dense peaks (H100 SXM data sheet)
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OP_PER_S = 1979e12
H100_L2_BYTES = 50 * 2 ** 20
# per SM and clock (Hopper tuning guide): fp32 instructions (128 lanes, an
# FMA one instruction: 132 x 128 x 2 x 1.98 GHz is the data sheet's 67 TFLOP/s
# fp32) and MUFU operations (exp2, rcp, rsqrt: 16)
FP32_LANES_PER_SM = 128
MUFU_PER_SM = 16


def resolve(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to run the plain twins on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def label(dev: torch.device) -> str:
    """``cuda <card name>``, or ``cpu``."""
    if dev.type == "cuda":
        return f"cuda {torch.cuda.get_device_name(dev)}"
    return "cpu"


def cpu_note(dev: torch.device) -> str:
    """What a line adds when it ran on the CPU: the plain twins, timed on the
    host's clock; nothing on the card."""
    return "" if dev.type == "cuda" else "  [cpu: plain twins, host clock]"


def l2_bytes(dev: torch.device) -> int:
    """The card's L2 size (``L2_cache_size``); on the CPU the H100's 50 MiB,
    so a CPU run rotates as the card would."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).L2_cache_size
    return H100_L2_BYTES


def sm_count(dev: torch.device) -> int:
    """The card's SMs."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def sm_clock_hz(dev: torch.device) -> float | None:
    """The card's highest SM clock (``nvidia-smi --query-gpu=clocks.max.sm``);
    None on the CPU, where no card's clock applies."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def cold_copies(nbytes: int, l2: int) -> int:
    """Copies of a call's inputs to rotate over so that one pass over them
    streams at least twice ``l2`` bytes: 1 when one call already does, else
    the next power of two of 2 l2 / nbytes."""
    if nbytes >= 2 * l2:
        return 1
    return 1 << max(0, math.ceil(math.log2(2 * l2 / nbytes)))


def residency(dev: torch.device, copies: int, nbytes: int) -> str:
    """Where a timed call's inputs came from: ``from HBM (n copies)`` when
    the calls streamed at least twice the L2 between two uses of one copy,
    else ``warm`` (the inputs may sit in L2); ``cpu`` on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    if copies * nbytes >= 2 * l2_bytes(dev):
        return f"from HBM ({copies} {'copy' if copies == 1 else 'copies'})"
    return "warm"


def time_ms(fn, dev: torch.device, iters: int = 20, reps: int = 3,
            copies: int | None = None) -> float:
    """Time of one call of ``fn``. On the card: ``iters`` back-to-back calls
    captured in a CUDA graph, replayed ``reps`` times between CUDA events
    (the host's launch cost stays out; calls on one stream run one after
    the other, so none is elided). On the CPU: the host clock.

    ``copies``: rotate over that many sets of inputs the caller allocated;
    ``fn(i)`` is then called with the set's index, and the graph holds a
    whole number of rotations, at least ``iters`` calls. With
    :func:`cold_copies` of the call's bytes, every call finds its inputs
    out of L2, as a call that streams weights from HBM does. Without it,
    ``fn()`` runs on the same tensors every call (warm where they fit L2)."""
    if copies is not None:
        if copies < 1:
            raise ValueError(f"copies must be >= 1, got {copies}")
        calls = -(-iters // copies) * copies
        order = [i % copies for i in range(calls)]
    else:
        order = [None] * iters

    def run(i):
        return fn() if i is None else fn(i)

    if dev.type != "cuda":
        run(order[0])
        t0 = time.perf_counter()
        for r in range(reps):
            run(order[r % len(order)])
        return 1e3 * (time.perf_counter() - t0) / reps
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in order[:3]:
            run(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in order:
            run(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(order) * reps)


def gemm_bound_ms(m: int, k: int, n: int) -> float:
    """Least time of a bf16 (m, k) @ (k, n) on the card: its flops at the
    bf16 peak, or its bytes (operands read once, bf16 out written once) at
    the memory rate, whichever is larger."""
    return 1e3 * max(2 * m * k * n / PEAK_BF16_FLOP_PER_S,
                     2 * (m * k + k * n + m * n) / PEAK_BYTES_PER_S)
