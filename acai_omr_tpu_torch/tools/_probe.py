"""What the probe tools share: the device they run on, its name, and a
timer."""

from __future__ import annotations

import time

import torch

# the card's published dense peaks (H100 SXM data sheet)
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_BYTES_PER_S = 3.35e12


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


def time_ms(fn, dev: torch.device, iters: int = 20, reps: int = 3) -> float:
    """Time of one call of ``fn``. On the card: ``iters`` back-to-back calls
    captured in a CUDA graph, replayed ``reps`` times between CUDA events
    (the host's launch cost stays out; calls on one stream run one after
    the other, so none is elided). On the CPU: the host clock."""
    if dev.type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def gemm_bound_ms(m: int, k: int, n: int) -> float:
    """Least time of a bf16 (m, k) @ (k, n) on the card: its flops at the
    bf16 peak, or its bytes (operands read once, bf16 out written once) at
    the memory rate, whichever is larger."""
    return 1e3 * max(2 * m * k * n / PEAK_BF16_FLOP_PER_S,
                     2 * (m * k + k * n + m * n) / PEAK_BYTES_PER_S)
