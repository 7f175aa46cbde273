"""The kernels of the GEMM, decode-attention and scratch probes.

Port of the Pallas kernels of the JAX package's probe tools (``tools/``),
which ask the questions a redesign of the training products and the decode
attention has to answer on the card:

* K16 :data:`tile_gemm` (``csrc/tile_gemm.cu``): ``tools/pallas_gemm_probe.py``
  ``make_mm`` and ``tools/mosaic_dot_forms_probe.py`` ``make_kernel``, one
  tensor-core GEMM over (BM, BN, BK) tiles in three operand layouts.
* K17 :data:`blockdiag_decode_attention` and K18
  :data:`batched_decode_attention` (``csrc/probe_decode_attention.cu``):
  ``tools/attn_microbench.py`` ``blockdiag_attn`` and ``batcheddot_attn``.
* K19 :data:`smem_probe` (``csrc/smem_probe.cu``): ``tools/vmem_probe.py``
  ``probe``.

Each has its plain PyTorch twin beside it, which the CPU tests use and the
card is held against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# K16's compiled variants: (layout, out dtype) -> (BM, BN, BK) tiles. The
# sweep's tiles fit Hopper's shared memory (two staged slabs of at most
# 104 KB); the dot forms run at two tiles.
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


def _launch_gemm(op, a, b, tile=(128, 128, 32), layout="nn",
                 out_dtype=torch.bfloat16):
    _build.require(a, "a", torch.bfloat16, 2)
    _build.require(b, "b", torch.bfloat16, 2)
    m, k, n = gemm_dims(a, b, layout)
    check_tile(m, k, n, tile, layout, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    fn = _build.bind("tile_gemm", "acai_tile_gemm",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                     + [ctypes.c_void_p])
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, *tile,
            LAYOUTS.index(layout), int(out_dtype == torch.float32),
            _build.stream_ptr())
    op.launched(f"{layout} {'x'.join(map(str, tile))} "
                f"{str(out_dtype).split('.')[-1]}")
    _build.check(rc, op.name)
    return out


tile_gemm = _build.KernelOp(
    "tile_gemm", "acai_omr_tpu_torch/csrc/tile_gemm.cu",
    "tools/pallas_gemm_probe.py:23 (make_mm, pallas_call :39); "
    "tools/mosaic_dot_forms_probe.py:23 (make_kernel, pallas_call :37)",
    _launch_gemm, tile_gemm_plain)


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


def blockdiag_decode_attention_plain(q, kT, vT, bias=None, k_scale=None,
                                     v_scale=None, bt: int = 4):
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


def _launch_blockdiag(op, q, kT, vT, bias=None, k_scale=None, v_scale=None,
                      bt: int = 4):
    int8 = kT.dtype == torch.int8
    _build.require(q, "q", torch.bfloat16, 3)
    for name, a in (("kT", kT), ("vT", vT)):
        _build.require(a, name, torch.int8 if int8 else torch.bfloat16, 4)
    b, h, dh, t = _check_attention(q, kT, vT, bias, bt)
    _check_blockdiag(q, kT, k_scale, v_scale)
    for name, a in (("bias", bias), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if a is not None:
            _build.require(a, name, torch.float32, a.dim())
    out = torch.empty_like(q)
    fn = _build.bind("probe_decode_attention",
                     "acai_blockdiag_decode_attention",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                     + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    ptr = lambda x: 0 if x is None else x.data_ptr()
    rc = fn(q.data_ptr(), kT.data_ptr(), vT.data_ptr(), ptr(bias),
            ptr(k_scale), ptr(v_scale), int(int8), b, bt, dh, t,
            1.0 / math.sqrt(dh), out.data_ptr(), _build.stream_ptr())
    op.launched(f"{'int8' if int8 else 'bf16'} bt={bt}")
    _build.check(rc, op.name)
    return out


blockdiag_decode_attention = _build.KernelOp(
    "blockdiag_decode_attention",
    "acai_omr_tpu_torch/csrc/probe_decode_attention.cu",
    "tools/attn_microbench.py:89 (_blockdiag_kernel via blockdiag_attn :129, "
    "pallas_call :151)", _launch_blockdiag, blockdiag_decode_attention_plain)


def batched_decode_attention_plain(q, kT, vT, bias=None, bt: int = 4):
    return decode_attention_probe_plain(q, kT, vT, bias, bt=bt)


def _launch_batched(op, q, kT, vT, bias=None, bt: int = 4):
    _build.require(q, "q", torch.bfloat16, 3)
    _build.require(kT, "kT", torch.bfloat16, 4)
    _build.require(vT, "vT", torch.bfloat16, 4)
    b, h, dh, t = _check_attention(q, kT, vT, bias, bt)
    if h != HEADS:
        raise ValueError(f"batched attention takes H = {HEADS} (a warp each)")
    if bias is not None:
        _build.require(bias, "bias", torch.float32, 2)
    out = torch.empty_like(q)
    fn = _build.bind("probe_decode_attention", "acai_batched_decode_attention",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                     + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    rc = fn(q.data_ptr(), kT.data_ptr(), vT.data_ptr(),
            0 if bias is None else bias.data_ptr(), b, bt, dh, t,
            1.0 / math.sqrt(dh), out.data_ptr(), _build.stream_ptr())
    op.launched(f"bt={bt}")
    _build.check(rc, op.name)
    return out


batched_decode_attention = _build.KernelOp(
    "batched_decode_attention",
    "acai_omr_tpu_torch/csrc/probe_decode_attention.cu",
    "tools/attn_microbench.py:157 (_batcheddot_kernel via batcheddot_attn "
    ":176, pallas_call :184)", _launch_batched, batched_decode_attention_plain)


# ---------------------------------------------------------------------------
# scratch capacity: K19
# ---------------------------------------------------------------------------

SMEM_ROW_BYTES = 128 * 2  # one (128,) bf16 row of the scratch


class SmemRefused(RuntimeError):
    """The card refused K19's scratch size: the probe's expected answer past
    the limit. ``code`` is the CUDA error."""

    def __init__(self, n_bytes: int, code: int, text: str):
        super().__init__(f"{n_bytes} bytes of shared memory refused: CUDA "
                         f"error {code} ({text})")
        self.n_bytes, self.code = n_bytes, code


def _check_smem(x: torch.Tensor, n_bytes: int) -> None:
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


def _launch_smem(op, x, n_bytes: int):
    _build.require(x, "x", torch.bfloat16, 2)
    _check_smem(x, n_bytes)
    out = torch.empty_like(x)
    fn = _build.bind("smem_probe", "acai_smem_probe",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    rc = fn(x.data_ptr(), out.data_ptr(), n_bytes, _build.stream_ptr())
    if rc != 0:  # refused: nothing launched
        raise SmemRefused(n_bytes, rc,
                          _smem_lib().acai_cuda_error_string(rc).decode())
    op.launched(f"{n_bytes // 1024} KB")
    return out


smem_probe = _build.KernelOp(
    "smem_probe", "acai_omr_tpu_torch/csrc/smem_probe.cu",
    "tools/vmem_probe.py:13 (probe, pallas_call :21)", _launch_smem,
    smem_probe_plain)


def smem_optin_bytes() -> int:
    """cudaDevAttrMaxSharedMemoryPerBlockOptin of the current CUDA device."""
    val = ctypes.c_int(0)
    fn = _build.bind("smem_probe", "acai_smem_optin",
                     [ctypes.POINTER(ctypes.c_int)])
    _build.check(fn(ctypes.byref(val)), "acai_smem_optin")
    return val.value
