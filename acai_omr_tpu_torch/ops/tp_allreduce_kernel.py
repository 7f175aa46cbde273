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

Two forms, chosen by the group's topology (:func:`allreduce_form`), each a
hand-written kernel, neither a fallback for the other:

* ``"local"``: every rank on one card (the emulated mesh: every shard on
  cuda:0). Every partial is readable in place, so one ordinary launch sums
  them once in the exchange's tree order and writes ``tp`` outputs, each
  with its rank's bias, into one ``(tp, B, E)`` buffer; the call returns its
  row views. No exchange state, no device context, E % 8 == 0.
* ``"coop"``: a group over several cards, the exchange. A :class:`TPGroup`
  holds its state: per buffer size, every rank's send slots ``(2 * nr, n)``
  fp32, its flag words ``(nr, chunks)`` and, per card, the epoch counter the
  kernel advances itself (so a CUDA graph may replay a launch). Ranks that
  share a card are one cooperative launch; each card launches once and needs
  peer access to the others (raised where missing).
  ``test_tp_allreduce_across_cards`` (cuda-marked, skipped below two cards)
  holds it bit-equal to the twin over 200 queued calls on two and four
  cards; ``variant="coop"`` forces it on one card, for timing the two forms
  in turns.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

MAX_TP = 4
CHUNK = 1024  # the exchange's elements a block and round (tp_allreduce.cu)
LOCAL_ELEMS = 8  # elements per thread of the one-card form
_PTRS = ctypes.c_void_p * MAX_TP


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
        self._one_card: bool | None = None

    @property
    def one_card(self) -> bool:
        """Whether every rank lies on one device (one launch set)."""
        if self._one_card is None:
            self._one_card = len(self.launch_sets()) == 1
        return self._one_card

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


def allreduce_form(group: TPGroup, variant: str | None = None) -> str:
    """The form of K15 a call on ``group`` takes: ``"local"`` where every
    rank lies on one card, ``"coop"`` (the exchange) where the group spans
    cards or ``variant="coop"`` asks for it. Raises ValueError on another
    variant, and on ``"local"`` for a group over several cards."""
    if variant not in (None, "local", "coop"):
        raise ValueError(f"unknown variant {variant!r}: 'local' or 'coop'")
    if variant == "coop" or not group.one_card:
        if variant == "local":
            raise ValueError("the one-card form needs every rank on one card")
        return "coop"
    return "local"


def local_plan(n: int, tp: int, in_dtype) -> tuple[int, int]:
    """(blocks, threads) of the one-card form for ``n`` elements a rank:
    one thread per LOCAL_ELEMS elements, blocks of 128 threads while the
    grid fits the card's SMs in one wave (every shape of the decode step:
    B <= 128 at E = 1024 is at most 128 blocks), else of 256. Raises
    ValueError on what the kernel does not take."""
    if tp not in (2, 4) or in_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tp_allreduce takes 2 or 4 ranks of fp32 or bf16, "
                         f"got {tp} of {in_dtype}")
    if n <= 0 or n % LOCAL_ELEMS:
        raise ValueError(f"tp_allreduce needs E % {LOCAL_ELEMS} == 0, got "
                         f"{n} elements")
    vectors = n // LOCAL_ELEMS
    threads = 128 if vectors <= 132 * 128 else 256
    return -(-vectors // threads), threads


def _check(parts, group, bias=None, out_dtype=None, variant=None):
    """K15's rules on either device: the form (:func:`allreduce_form`),
    fp32 or bf16 in and out, one (B, E) shape with E % 8 == 0, one bias per
    rank of (E,)."""
    form = allreduce_form(group, variant)
    tp = len(parts)
    if group.tp != tp:
        raise ValueError(f"{tp} parts for a group of {group.tp}")
    dt = parts[0].dtype
    out_dtype = dt if out_dtype is None else out_dtype
    if dt not in (torch.float32, torch.bfloat16) \
            or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tp_allreduce takes fp32 or bf16, got {dt} -> "
                         f"{out_dtype}")
    shape = parts[0].shape
    if len(shape) != 2 or shape[1] % LOCAL_ELEMS:
        raise ValueError(f"tp_allreduce takes (B, E) parts with "
                         f"E % {LOCAL_ELEMS} == 0, got {tuple(shape)}")
    for r, p in enumerate(parts):
        if p.shape != shape or p.dtype != dt:
            raise ValueError(f"parts[{r}] must be {tuple(shape)} {dt}")
    if bias is not None and (len(bias) != tp or any(
            bv.shape != shape[1:] for bv in bias)):
        raise ValueError(f"bias must be {tp} vectors of ({shape[1]},)")
    return form, dt, out_dtype


def _local_fn():
    return _build.bind("tp_allreduce", "acai_tp_allreduce_local",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])


def _pointers(tensors, devices, what: str) -> list[int]:
    """The tensors' addresses, each checked contiguous, 16-byte aligned and
    on its rank's device."""
    ptrs = []
    for r, (t, d) in enumerate(zip(tensors, devices)):
        ptr = t.data_ptr()
        if ptr % 16 or not t.is_contiguous() or t.device != d:
            raise ValueError(f"{what}[{r}] must be contiguous, 16-byte "
                             f"aligned, on {d}")
        ptrs.append(ptr)
    return ptrs


def _launch(op, parts, group, bias=None, out_dtype=None, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"coop"`` forces the
    exchange on a one-card group. Returns one output per rank: on one card
    the rows of one (tp, B, E) tensor."""
    form, dt, out_dtype = _check(parts, group, bias, out_dtype, variant)
    tp = len(parts)
    if tp not in (2, 4):
        raise ValueError(f"tp_allreduce takes 2 or 4 ranks, got {tp} parts "
                         f"for a group of {group.tp}")
    b, e = parts[0].shape
    n = b * e
    devs = group.devices
    in_ptrs = _pointers(parts, devs, "parts")
    bias_ptrs = None
    if bias is not None:
        if any(bv.dtype != torch.float32 for bv in bias):
            raise ValueError("tp_allreduce takes an fp32 bias")
        bias_ptrs = _pointers(bias, devs, "bias")
    in_bf16, out_bf16 = int(dt == torch.bfloat16), \
        int(out_dtype == torch.bfloat16)
    if form == "local":
        blocks, threads = local_plan(n, tp, dt)
        out = torch.empty((tp, b, e), dtype=out_dtype, device=devs[0])
        rc = _local_fn()(
            _PTRS(*in_ptrs), None if bias_ptrs is None else _PTRS(*bias_ptrs),
            out.data_ptr(), tp, n, e, in_bf16, out_bf16, blocks, threads,
            _build.stream_ptr())
        op.launched("local")
        _build.check(rc, op.name)
        return out.unbind(0)
    sets = group.launch_sets()
    multi = len(sets) > 1
    if multi:
        group.enable_peer_access()
    ws = group.workspace(n)
    outs = [torch.empty((b, e), dtype=out_dtype, device=d) for d in devs]
    pad = [None] * (MAX_TP - tp)
    table = (_PTRS(*in_ptrs, *pad),
             _PTRS(*[o.data_ptr() for o in outs], *pad),
             _PTRS(*([None] * tp if bias_ptrs is None else bias_ptrs), *pad),
             _PTRS(*[s.data_ptr() for s in ws.slots], *pad),
             _PTRS(*[f.data_ptr() for f in ws.flags], *pad))
    fn = _build.bind("tp_allreduce", "acai_tp_allreduce",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    for dev, rank0, n_local in sets:
        with torch.cuda.device(dev):
            rc = fn(*table, tp, rank0, n_local, n, e, in_bf16, out_bf16,
                    ws.counters[dev].data_ptr(), int(multi),
                    _build.stream_ptr())
        op.launched("coop")
        _build.check(rc, op.name)
    return outs


class _GroupOp(_build.KernelOp):
    """A kernel whose first argument is one tensor per rank: the kernel when
    every part lies on a CUDA device, the twin when every part lies on the
    CPU."""

    def __call__(self, parts, *args, **kwargs):
        kinds = {p.device.type for p in parts}
        if kinds == {"cpu"}:
            self.check(parts, *args, **kwargs)
            kwargs.pop("variant", None)
            return self.plain(parts, *args, **kwargs)
        if kinds != {"cuda"}:
            raise ValueError(f"{self.name}: parts on {sorted(kinds)}")
        return self._launch(self, parts, *args, **kwargs)


tp_allreduce = _GroupOp(
    "tp_allreduce", "acai_omr_tpu_torch/csrc/tp_allreduce.cu",
    "acai_omr_tpu/ops/pallas_monolith.py:1068 (tp_allreduce in _kernel; "
    "scratch :1790-1800, peers :1575-1587)",
    _launch, tp_allreduce_plain, _check)
