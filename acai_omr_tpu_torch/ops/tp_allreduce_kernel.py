"""K15 ``tp_allreduce``: the all-reduce of the tensor-parallel decode step.

CUDA source: ``csrc/tp_allreduce.cu`` (bound, protocol and the TPU kernel it
replaces are noted there). The decoder's three row-parallel products of each
layer (self out, cross out, ff2) leave one partial ``(B, E)`` per model rank;
this op gives every rank ``round(sum of the partials + bias)``, summed by
recursive doubling as the JAX package's in-kernel ``tp_allreduce``: round r
adds the running sum of the rank at ``rank ^ (1 << r)``, so tp = 2 computes
``p0 + p1`` and tp = 4 ``(p0 + p1) + (p2 + p3)``, the same bits on every rank.

Two uses:

* the monolith step: fp32 partials, the fp32 bias added once after the sum,
  output in the compute dtype (``(tp_allreduce(mat(...)) + b).astype(dtype)``
  in the JAX kernel);
* the per-op step: partials in the compute dtype, the running sum rounded to
  it after every round (``lax.psum`` of a compute-dtype dot), no bias.

A :class:`TPGroup` is the model-axis ranks of one data coordinate, each with
its device (several ranks may share one), and holds the exchange state: per
buffer size, every rank's send slots ``(2 * nr, n)`` fp32, its flag words
``(nr, chunks)`` and, per card, the epoch counter the kernel advances itself
(so a CUDA graph may replay a launch). Ranks that share a card are
one cooperative launch; a group over several cards launches once per card and
needs peer access between them (raised where missing). A one-card mesh never
runs that multi-card form; ``test_tp_allreduce_across_cards`` (cuda-marked,
skipped below two cards) holds it bit-equal to the twin over 200 queued calls
on two and four cards.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

MAX_TP = 4
CHUNK = 1024  # elements per block and round (csrc/tp_allreduce.cu)


def canonical_device(d) -> torch.device:
    """``d`` as a device with its index (``cuda`` -> ``cuda:<current>``), so
    that devices compare equal to the ones tensors report."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class _Workspace:
    def __init__(self, group: "TPGroup", n: int):
        nr = group.rounds
        chunks = -(-n // CHUNK)
        self.slots, self.flags = [], []
        # per card: [epoch (the next call's, from 1), finished blocks]
        self.counters = {d: torch.tensor([1, 0], dtype=torch.int32, device=d)
                         for d in dict.fromkeys(group.devices)}
        by_dev = {}
        for r, dev in enumerate(group.devices):
            # ranks on one card share one allocation each (a few MB at most)
            if dev not in by_dev:
                local = group.devices.count(dev)
                by_dev[dev] = (
                    torch.empty((local, 2 * nr, n), dtype=torch.float32,
                                device=dev),
                    torch.zeros((local, nr, chunks), dtype=torch.int32,
                                device=dev), [0])
            slots, flags, used = by_dev[dev]
            self.slots.append(slots[used[0]])
            self.flags.append(flags[used[0]])
            used[0] += 1
        if len(by_dev) > 1:
            # a card reads its peers' flags with no stream order between
            # them: every card's zeroed flags must have landed first
            for dev in by_dev:
                torch.cuda.synchronize(dev)


class TPGroup:
    """The ranks of one tensor-parallel group and K15's exchange state.

    ``devices[r]`` is rank r's device; tp = ``len(devices)`` is 2 or 4 for
    the kernel (the plain twin takes any power of two)."""

    def __init__(self, devices: Sequence):
        self.devices = [canonical_device(d) for d in devices]
        tp = len(self.devices)
        if tp < 1 or tp & (tp - 1):
            raise ValueError(f"a TP group needs a power-of-two size, got {tp}")
        self.tp = tp
        self.rounds = tp.bit_length() - 1
        self._spaces: dict[int, _Workspace] = {}
        self._peers_enabled = False

    def peers(self, rank: int) -> list[int]:
        """Rank ``rank``'s peer in each recursive-doubling round."""
        return [rank ^ (1 << r) for r in range(self.rounds)]

    def workspace(self, n: int) -> _Workspace:
        ws = self._spaces.get(n)
        if ws is None:
            ws = self._spaces[n] = _Workspace(self, n)
        return ws

    def launch_sets(self) -> list[tuple[torch.device, int, int]]:
        """(device, first rank, ranks) of each launch: the ranks of one card,
        which must be consecutive."""
        sets = []
        for r, dev in enumerate(self.devices):
            if sets and sets[-1][0] == dev:
                sets[-1][2] += 1
            else:
                if any(s[0] == dev for s in sets):
                    raise ValueError("the ranks of one card must be "
                                     "consecutive in a TP group")
                sets.append([dev, r, 1])
        return [tuple(s) for s in sets]

    def enable_peer_access(self) -> None:
        """Map every card of the group into every other (the multi-card
        form); raises where two cards cannot reach each other."""
        if self._peers_enabled:
            return
        cards = sorted({d.index for d in self.devices})
        fn = _build.bind("tp_allreduce", "acai_tp_enable_peer_access",
                         [ctypes.c_int, ctypes.c_int])
        for a in cards:
            for b in cards:
                if a != b:
                    rc = fn(a, b)
                    if rc != 0:
                        raise RuntimeError(
                            f"tp_allreduce: cuda:{a} cannot map cuda:{b} "
                            f"(peer access, CUDA error {rc})")
        self._peers_enabled = True


def tp_allreduce_plain(parts: Sequence[torch.Tensor], group: TPGroup | None
                       = None, bias: Sequence[torch.Tensor] | None = None,
                       out_dtype=None) -> list[torch.Tensor]:
    """Plain twin: recursive doubling in fp32, the running sum rounded to the
    partials' dtype after every round (a no-op for fp32), then the fp32 bias
    and the output dtype. Returns one tensor per rank, on that rank's
    device."""
    del group
    tp = len(parts)
    dt = parts[0].dtype
    out_dtype = dt if out_dtype is None else out_dtype
    acc = [p.float() for p in parts]
    for r in range(tp.bit_length() - 1):
        acc = [(acc[i] + acc[i ^ (1 << r)].to(acc[i].device)).to(dt).float()
               for i in range(tp)]
    if bias is not None:
        acc = [a + b.float() for a, b in zip(acc, bias)]
    return [a.to(out_dtype) for a in acc]


def _launch(op, parts, group, bias=None, out_dtype=None):
    tp = len(parts)
    if tp not in (2, 4) or group.tp != tp:
        raise ValueError(f"tp_allreduce takes 2 or 4 ranks, got {tp} parts "
                         f"for a group of {group.tp}")
    dt = parts[0].dtype
    out_dtype = dt if out_dtype is None else out_dtype
    if dt not in (torch.float32, torch.bfloat16) \
            or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tp_allreduce takes fp32 or bf16, got {dt} -> "
                         f"{out_dtype}")
    shape = parts[0].shape
    for r, p in enumerate(parts):
        _build.require(p, f"parts[{r}]", dt, 2)
        if p.shape != shape or p.device != group.devices[r]:
            raise ValueError(f"parts[{r}] must be {tuple(shape)} on "
                             f"{group.devices[r]}")
        if p.data_ptr() % 16:
            raise ValueError(f"parts[{r}] must be 16-byte aligned")
    b, e = shape
    if bias is not None:
        for r, bv in enumerate(bias):
            _build.require(bv, f"bias[{r}]", torch.float32, 1)
            if bv.shape[0] != e or bv.device != group.devices[r]:
                raise ValueError(f"bias[{r}] must be ({e},) on "
                                 f"{group.devices[r]}")
    n = b * e
    if n % 4 or e % 4:
        raise ValueError(f"tp_allreduce needs E % 4 == 0, got E={e}")
    sets = group.launch_sets()
    multi = len(sets) > 1
    if multi:
        group.enable_peer_access()
    ws = group.workspace(n)
    outs = [torch.empty((b, e), dtype=out_dtype, device=d)
            for d in group.devices]
    vp = ctypes.c_void_p * MAX_TP
    pad = [None] * (MAX_TP - tp)
    table = (vp(*[p.data_ptr() for p in parts], *pad),
             vp(*[o.data_ptr() for o in outs], *pad),
             vp(*([None] * tp if bias is None else
                  [bv.data_ptr() for bv in bias]), *pad),
             vp(*[s.data_ptr() for s in ws.slots], *pad),
             vp(*[f.data_ptr() for f in ws.flags], *pad))
    fn = _build.bind("tp_allreduce", "acai_tp_allreduce",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    for dev, rank0, n_local in sets:
        with torch.cuda.device(dev):
            rc = fn(*table, tp, rank0, n_local, n, e,
                    int(dt == torch.bfloat16),
                    int(out_dtype == torch.bfloat16),
                    ws.counters[dev].data_ptr(), int(multi),
                    _build.stream_ptr())
        op.launches += 1
        _build.check(rc, op.name)
    return outs


class _GroupOp(_build.KernelOp):
    """A kernel whose first argument is one tensor per rank: the kernel when
    every part lies on a CUDA device, the twin when every part lies on the
    CPU."""

    def __call__(self, parts, *args, **kwargs):
        kinds = {p.device.type for p in parts}
        if kinds == {"cpu"}:
            return self.plain(parts, *args, **kwargs)
        if kinds != {"cuda"}:
            raise ValueError(f"{self.name}: parts on {sorted(kinds)}")
        return self._launch(self, parts, *args, **kwargs)


tp_allreduce = _GroupOp(
    "tp_allreduce", "acai_omr_tpu_torch/csrc/tp_allreduce.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:1068 (tp_allreduce in _kernel; "
    "scratch :1790-1800, peers :1575-1587)",
    _launch, tp_allreduce_plain)
