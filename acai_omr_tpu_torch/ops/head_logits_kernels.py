"""The kernels of the two head-access probes: K25 :data:`head_logits` and K26
:data:`batched_head_logits` (``csrc/head_logits.cu``).

Port of the Pallas kernels of ``tools/mosaic_head_access_probe.py`` (``main``:
``k1``, ``k2``, ``k3``) and ``tools/mosaic_batched_attn_probe.py`` (``run``:
``kern`` / ``kernel``), which ask how a kernel should reach one head of a
fused row-major buffer, and how single-query logits of a batch are laid out.
Each has its plain PyTorch twin beside it. K25 runs on persistent blocks
(:func:`head_logits_blocks`) that walk the tiles of
:func:`head_logits_schedule`; ``variant="wmma"`` forces the kernel it
replaced, kept as the yardstick.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .linear_kernel import N_SMS

DH = 64  # the head width both kernels are compiled for
FORMS = ("lane_slice", "reshape", "preshaped")
TILE_Q, TILE_K = 64, 128  # K25: queries x keys of one head a tile
BLOCKS_PER_SM = 2  # K25's persistent blocks (81 KB of shared memory each)
MAX_KEYS = 1024  # K26: keys a (b, h) pair holds in shared memory


# ---------------------------------------------------------------------------
# K25: per-head logits in three access forms
# ---------------------------------------------------------------------------

def head_dims(q: torch.Tensor, k: torch.Tensor, form: str,
              num_heads: int) -> int:
    """T of a K25 call; raises on what the kernel does not take. ``lane_slice``
    and ``reshape`` take q, k (T, H * 64); ``preshaped`` (H, T, 64)."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    want = 3 if form == "preshaped" else 2
    if q.dim() != want or q.shape != k.shape:
        raise ValueError(f"{form} takes q and k of one {want}-d shape, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if form == "preshaped":
        h, t, dh = q.shape
    else:
        t, e = q.shape
        h, dh = num_heads, e // max(num_heads, 1)
        if h * dh != e:
            raise ValueError(f"E={e} is not {num_heads} heads")
    if h != num_heads or dh != DH:
        raise ValueError(f"head_logits takes {num_heads} heads of {DH}, got "
                         f"{h} of {dh}")
    if t % 64 or t == 0:
        raise ValueError(f"T must be a positive multiple of 64, got {t}")
    return t


def as_heads(a: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(T, H * Dh) -> the (H, T, Dh) view of its heads."""
    t, e = a.shape
    return a.view(t, num_heads, e // num_heads).transpose(0, 1)


def head_logits_plain(q: torch.Tensor, k: torch.Tensor, form: str,
                      num_heads: int) -> torch.Tensor:
    """Plain twin of K25: S[h] = Q_h K_h^T, (H, T, T) fp32 from the bf16
    values (exact products, fp32 sums)."""
    head_dims(q, k, form, num_heads)
    if form != "preshaped":
        q, k = as_heads(q, num_heads), as_heads(k, num_heads)
    return torch.einsum("htd,hsd->hts", q.float(), k.float())


def head_logits_tiles(t: int, h: int) -> int:
    """K25's tiles at T keys and H heads: H x T / 64 x ceil(T / 128)."""
    return h * (t // TILE_Q) * -(-t // TILE_K)


def head_logits_blocks(t: int, h: int) -> int:
    """K25's persistent blocks: two an SM, no more than the tiles."""
    return min(head_logits_tiles(t, h), BLOCKS_PER_SM * N_SMS)


def head_logits_tile(i: int, t: int, h: int, form: str) -> tuple:
    """(head, first query, first key) of K25's tile ``i`` as the kernel
    orders them: ``lane_slice`` the heads innermost (then key tiles, then
    query tiles), ``reshape`` / ``preshaped`` the heads outermost (then
    query tiles, then key tiles)."""
    nq, nk = t // TILE_Q, -(-t // TILE_K)
    if form == "lane_slice":
        hh, kt, qt = i % h, i // h % nk, i // h // nk
    else:
        kt, qt, hh = i % nk, i // nk % nq, i // nk // nq
    return hh, qt * TILE_Q, kt * TILE_K


def head_logits_schedule(t: int, h: int, form: str,
                         blocks: int | None = None) -> list[list[tuple]]:
    """The tiles each of K25's persistent blocks computes, in order: block b
    walks tiles [b N / G, (b + 1) N / G) of the N tiles, G the blocks."""
    n = head_logits_tiles(t, h)
    g = head_logits_blocks(t, h) if blocks is None else blocks
    return [[head_logits_tile(i, t, h, form)
             for i in range(b * n // g, (b + 1) * n // g)] for b in range(g)]


def _check_heads(q, k, form, num_heads, variant=None) -> int:
    """K25's shape rules and its variant, on either device: T."""
    if variant not in (None, "wmma"):
        raise ValueError(f"unknown variant {variant!r}: None (the persistent "
                         f"kernel) or 'wmma'")
    return head_dims(q, k, form, num_heads)


def _launch_heads(op, q, k, form, num_heads, variant=None):
    """``variant`` (private: tests and chip_smoke.py): ``"wmma"`` forces the
    kernel the persistent one replaced."""
    t = _check_heads(q, k, form, num_heads, variant)
    for a, what in ((q, "q"), (k, "k")):
        _build.require(a, what, torch.bfloat16, q.dim())
    out = torch.empty((num_heads, t, t), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), out.data_ptr(), t, num_heads,
            FORMS.index(form))
    if variant == "wmma":
        fn = _build.bind("head_logits", "acai_head_logits",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
        rc = fn(*args, _build.stream_ptr())
        op.launched(f"{form} wmma")
    else:
        fn = _build.bind("head_logits", "acai_head_logits_persistent",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
        rc = fn(*args, head_logits_blocks(t, num_heads), _build.stream_ptr())
        op.launched(form)
    _build.check(rc, op.name)
    return out


head_logits = _build.KernelOp(
    "head_logits", "acai_omr_tpu_torch/csrc/head_logits.cu",
    "tools/mosaic_head_access_probe.py:35 (main: k1 :44, k2 :58, k3 :78; "
    "pallas_call :52, :66, :83)",
    _launch_heads, head_logits_plain, _check_heads)


# ---------------------------------------------------------------------------
# K26: batched single-query logits
# ---------------------------------------------------------------------------

def batched_dims(k: torch.Tensor, q: torch.Tensor,
                 num_heads: int) -> tuple[int, int]:
    """(BT, T) of a K26 call; raises on what the kernel does not take."""
    if k.dim() != 3 or k.dtype not in (torch.float32, torch.int8):
        raise ValueError("k must be (BT, T, E) fp32 or int8")
    bt, t, e = k.shape
    if tuple(q.shape) != (bt, e) or q.dtype != torch.float32:
        raise ValueError(f"q must be ({bt}, {e}) fp32")
    if e != num_heads * DH:
        raise ValueError(f"E={e} must be {num_heads} heads of {DH}")
    if not 0 < t <= MAX_KEYS:
        raise ValueError(f"T must lie in 1..{MAX_KEYS}, got {t}")
    return bt, t


def batched_head_logits_plain(k: torch.Tensor, q: torch.Tensor,
                              num_heads: int) -> tuple:
    """Plain twin of K26 -> (compact (T, BT H), colsum (1, BT H), col
    (BT H, 1)), fp32. int8 ``k``: q rounded half to even to int8 (it must
    lie in [-128, 127]), sums exact in float64 (every partial sum is an
    integer below 2^53) and converted once."""
    bt, t = batched_dims(k, q, num_heads)
    k4 = k.view(bt, t, num_heads, DH)
    q3 = q.view(bt, num_heads, DH)
    if k.dtype == torch.int8:
        q3 = torch.round(q3).to(torch.int8)
        sums = torch.einsum("bthd,bhd->tbh", k4.double(), q3.double())
        compact = sums.reshape(t, bt * num_heads)
        colsum = compact.sum(0, keepdim=True).float()
        compact = compact.float()
    else:
        compact = torch.einsum("bthd,bhd->tbh", k4, q3).reshape(
            t, bt * num_heads)
        colsum = compact.sum(0, keepdim=True)
    return compact, colsum, colsum.t().contiguous()


def _launch_batched(op, k, q, num_heads):
    bt, t = batched_dims(k, q, num_heads)
    _build.require(k, "k", k.dtype, 3)
    _build.require(q, "q", torch.float32, 2)
    nl = bt * num_heads
    compact = torch.empty((t, nl), dtype=torch.float32, device=k.device)
    colsum = torch.empty((1, nl), dtype=torch.float32, device=k.device)
    col = torch.empty((nl, 1), dtype=torch.float32, device=k.device)
    fn = _build.bind("head_logits", "acai_batched_head_logits",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    int8 = k.dtype == torch.int8
    rc = fn(k.data_ptr(), q.data_ptr(), compact.data_ptr(), colsum.data_ptr(),
            col.data_ptr(), bt, t, num_heads, int(int8), _build.stream_ptr())
    op.launched("int8" if int8 else "fp32")
    _build.check(rc, op.name)
    return compact, colsum, col


batched_head_logits = _build.KernelOp(
    "batched_head_logits", "acai_omr_tpu_torch/csrc/head_logits.cu",
    "tools/mosaic_batched_attn_probe.py:77 (run: kern :86 / kernel :31, "
    "pallas_call :117)",
    _launch_batched, batched_head_logits_plain)
