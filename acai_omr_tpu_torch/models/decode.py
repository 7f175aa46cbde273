"""KV-cached decode -- the hot path of inference.

The twin of the JAX package's ``models/decode.py`` on one card:
:func:`generate` (greedy or top-k / temperature sampled, optionally with G
rows per memory row), :func:`beam_generate` and :func:`streamed_generate`,
with caches in the compute dtype or int8. Two steps, told apart by the
caches' ``ndim`` as in JAX:

* **The monolith step** (``ops.decode_kernel.use_monolith()``, the default,
  where ``ops.decode_kernel.monolith_takes`` says its kernels take the
  decoder's shapes on the device: :func:`_monolith_for`):
  time-major caches ``(L, B, T, E)`` appended in place by
  :func:`..ops.decode_kernel.decode_layers` (K1 or K5, K2 or K6, K4). Memory
  K/V in the ``te`` layout ``(L, B, M, E)``. ``cache_dtype=torch.int8`` is the
  JAX monolith's quantized mode: int8 K/V with per (row, position, head) bf16
  scales ``(L, B, T, H)``, quantized attention and, as the weight switches
  say (:func:`_prepack_for`), int8 weights (W8A8, the default), int4 weights
  (W4A8) or compute-dtype weights. The cache length is a multiple of the JAX
  monolith's time tile.
* **The per-op step** (``ACAI_MONOLITH_DECODE=0``): lane-major caches
  ``(L, B, H, Dh, T)`` and memory ``(L, B, H, Dh, M)`` (the ``hd`` layout),
  int8 with fp32 scales ``(L, B, H, T)``; the products, LayerNorms and GELU in
  plain PyTorch with the weights in the compute dtype; the attention through
  :mod:`..ops.decode_hd_kernel` where its switches say so (K11 for the compute
  dtype, ``ACAI_PALLAS_DECODE=1``; K13 for the int8 self-attention and K12
  for the int8 cross-attention, ``ACAI_PALLAS_DECODE_INT8``, on by default),
  else :func:`decode_attention`. No time-tile rounding.

Common to both:

* Cross-attention K/V are projected once per batch from the stacked cross
  ``in_kernel`` kv columns (:func:`precompute_memory_kv`).
* Segmented cache growth: the cache starts at ``initial_segment`` slots and
  grows (256, then doubling, capped at ``max_len``) only when a segment
  fills, so short sequences only ever touch short caches.
* Finished-row compaction at segment boundaries down to power-of-two row
  counts (of groups, with ``mem_group``), so finished rows stop paying for
  cache bandwidth.
* Beams decode ``K`` rows per image over the un-replicated memory
  (``mem_group=K``); caches and scales are reordered by parent every step.
* Sampling (:class:`SamplingConfig`) takes top-k of the fp32 logits, draws
  ``argmax(topk / temperature + Gumbel)`` with noise from an explicit
  ``torch.Generator`` and records the log-prob under the untempered top-k
  ``log_softmax``.
* The final norm, the unembedding and the argmax / sampling stay outside the
  layer kernels.

Over a :class:`..parallel.mesh.Mesh` (:func:`sharded_generate`,
:func:`sharded_beam_generate`), each data shard decodes its rows, and a
model axis of tp > 1 splits heads and MLP columns over the ranks
(:func:`prepare_tp_decode_params`): either step then runs per rank on lists
of operands, with K15 ``tp_allreduce`` summing the row-parallel products.

The token loop runs on the host; the all-finished early exit is checked every
``FINISH_CHECK_STEPS`` steps so the host does not wait on the card every
token (rows decode independently, so a few extra steps after every row has
finished change no kept token: :func:`mask_and_clip_seqs` masks them).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import decode_hd_kernel as hd
from ..ops import nn
from ..ops.decode_kernel import (decode_layers, monolith_takes, prepack,
                                 quantize_rows, use_monolith,
                                 weight_quant_mode)
from ..ops.tp_allreduce_kernel import tp_allreduce
from .omr_decoder import DecoderConfig

Params = dict

# the monolith's cache time axis is kept a multiple of the JAX monolith's time
# tile so segment boundaries (and hence compaction points) fall where they do
# there
TIME_TILE = 16
INT8_TIME_TILE = 32
FINISH_CHECK_STEPS = 16
SCALE_DTYPE = torch.bfloat16


def time_tile(cache_dtype) -> int:
    return INT8_TIME_TILE if cache_dtype == torch.int8 else TIME_TILE


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Top-k + temperature sampling of GRPO rollouts."""
    top_k: int = 50
    temperature: float = 1.1


@dataclasses.dataclass
class MemoryKV:
    """Per-layer cross-attention keys/values and the (B, M) fp32 additive
    padding bias (0 valid / -1e9 padding). ``te`` layout: (L, B, M, E), int8
    with (L, B, M, H) bf16 scales; ``hd`` layout: (L, B, H, Dh, M), int8 with
    (L, B, H, M) fp32 scales."""
    k: torch.Tensor
    v: torch.Tensor
    bias: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    def rows(self, sel: torch.Tensor) -> "MemoryKV":
        pick = lambda a: None if a is None else a[:, sel].contiguous()
        return MemoryKV(pick(self.k), pick(self.v), self.bias[sel].contiguous(),
                        pick(self.k_scale), pick(self.v_scale))


@dataclasses.dataclass
class DecodeState:
    seqs: torch.Tensor       # (B, max_len) int64, pos 0 = <bos>
    log_probs: torch.Tensor  # (B, max_len) float32
    finished: torch.Tensor   # (B,) bool
    t: int                   # next position to fill
    # (L, B, T_cache, E) or (L, B, H, Dh, T_cache); under tensor parallelism
    # a list with one per rank, over its H / tp heads
    k_cache: torch.Tensor
    v_cache: torch.Tensor
    # int8 caches: per-written-position scales, (L, B, T_cache, H) bf16 or
    # (L, B, H, T_cache) fp32 (lists under tensor parallelism)
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def precompute_memory_kv(params: Params, cfg: DecoderConfig,
                         img_latent: torch.Tensor,
                         latent_valid: torch.Tensor | None,
                         compute_dtype=torch.bfloat16,
                         cache_dtype=torch.bfloat16,
                         layout: str = "te") -> MemoryKV:
    """Project encoder memory into per-layer cross K/V once per batch, in the
    monolith step's ``te`` layout or the per-op step's ``hd`` layout."""
    e, h = cfg.hidden_dim, cfg.num_heads
    b, m = img_latent.shape[:2]
    ca = params["blocks"]["cross_attn"]
    mem = img_latent.to(compute_dtype)
    quantized = cache_dtype == torch.int8
    cols = [[], [], [], []]  # k, v, k_scale, v_scale
    for i in range(cfg.num_layers):
        kv = torch.matmul(mem, ca["in_kernel"][i, :, e:].to(compute_dtype)) \
            + ca["in_bias"][i, e:].to(compute_dtype)
        for j, x in enumerate((kv[..., :e], kv[..., e:])):
            x = x.reshape(b, m, h, -1)
            if layout == "hd":  # rows of (B, H, M, Dh), stored (B, H, Dh, M)
                x = x.permute(0, 2, 1, 3)
                if quantized:
                    q, s = quantize_rows(x)
                    cols[j].append(q.transpose(-1, -2))
                    cols[2 + j].append(s)
                else:
                    cols[j].append(x.transpose(-1, -2).to(cache_dtype))
            elif quantized:
                q, s = quantize_rows(x.float(), SCALE_DTYPE)
                cols[j].append(q.reshape(b, m, e))
                cols[2 + j].append(s.to(SCALE_DTYPE))
            else:
                cols[j].append(x.reshape(b, m, e).to(cache_dtype))
    if latent_valid is None:
        bias = torch.zeros((b, m), dtype=torch.float32, device=mem.device)
    else:
        bias = torch.where(latent_valid, 0.0, nn.NEG_INF).float()
    stack = lambda c: torch.stack(c).contiguous() if c else None
    return MemoryKV(stack(cols[0]), stack(cols[1]), bias.contiguous(),
                    stack(cols[2]), stack(cols[3]))


def _init_caches(cfg: DecoderConfig, rows: int, cache_len: int, cache_dtype,
                 device, monolith: bool, tp: int = 1):
    """Zero K/V caches, time-major (L, rows, cache_len, E) for the monolith
    step or lane-major (L, rows, H, Dh, cache_len) for the per-op step; int8
    caches come with all-ones scales ((L, rows, cache_len, H) bf16 /
    (L, rows, H, cache_len) fp32). ``tp``: one tensor-parallel rank's
    caches, over H / tp heads."""
    l, h = cfg.num_layers, cfg.num_heads // tp
    if monolith:
        shape = (l, rows, cache_len, h * cfg.head_dim)
        scale_shape, scale_dtype = shape[:3] + (h,), SCALE_DTYPE
    else:
        shape = (l, rows, h, cfg.head_dim, cache_len)
        scale_shape, scale_dtype = (l, rows, h, cache_len), torch.float32
    kv = [torch.zeros(shape, dtype=cache_dtype, device=device)
          for _ in range(2)]
    scales = [None, None]
    if cache_dtype == torch.int8:
        scales = [torch.ones(scale_shape, dtype=scale_dtype, device=device)
                  for _ in range(2)]
    return (*kv, *scales)


def _state_caches(cfg, rows, cache_len, cache_dtype, device, monolith,
                  tp_devices):
    """(k, v, k_scale, v_scale) of a fresh state: tensors, or with
    ``tp_devices`` one list per field, rank r's caches on tp_devices[r]."""
    if tp_devices is None:
        return _init_caches(cfg, rows, cache_len, cache_dtype, device,
                            monolith)
    per = [_init_caches(cfg, rows, cache_len, cache_dtype, dv, monolith,
                        len(tp_devices)) for dv in tp_devices]
    return tuple(None if c[0] is None else list(c) for c in zip(*per))


def init_decode_state(cfg: DecoderConfig, batch_size: int, max_len: int,
                      cache_len: int, cache_dtype=torch.bfloat16,
                      device="cpu", monolith: bool = True,
                      tp_devices=None) -> DecodeState:
    """Fresh decode state with <bos>-seeded sequences; ``monolith=False``
    allocates the per-op step's lane-major caches. ``tp_devices``: one cache
    per tensor-parallel rank, over its H / tp heads, on its device."""
    seqs = torch.full((batch_size, max_len), cfg.pad_idx, dtype=torch.long,
                      device=device)
    seqs[:, 0] = cfg.bos_idx
    return DecodeState(
        seqs, torch.zeros((batch_size, max_len), dtype=torch.float32,
                          device=device),
        torch.zeros((batch_size,), dtype=torch.bool, device=device), 1,
        *_state_caches(cfg, batch_size, cache_len, cache_dtype, device,
                       monolith, tp_devices))


def _per_rank(fn, a):
    """``fn`` over a cache tensor, or over each rank's tensor of a
    tensor-parallel state (a list); None stays None."""
    if a is None:
        return None
    return [fn(x) for x in a] if isinstance(a, list) else fn(a)


def cache_len_of(k_cache) -> int:
    """Sequence capacity of a cache in either layout (or of a
    tensor-parallel state's per-rank caches)."""
    if isinstance(k_cache, list):
        k_cache = k_cache[0]
    return k_cache.shape[2] if k_cache.dim() == 4 else k_cache.shape[-1]


def grow_cache(state, new_cache_len: int):
    """Pad the KV caches with zeros, and int8 scales with ones, to a longer
    segment (``state``: a :class:`DecodeState` or a :class:`BeamState`, with
    one cache per rank under tensor parallelism): along axis 2 of
    time-major caches, along the last axis of lane-major ones."""
    cur = cache_len_of(state.k_cache)
    if new_cache_len <= cur:
        return state
    n = new_cache_len - cur
    first = state.k_cache[0] if isinstance(state.k_cache, list) \
        else state.k_cache
    # F.pad counts dims from the last: (0, 0, 0, n) pads axis -2
    widths = (0, 0, 0, n) if first.dim() == 4 else (0, n)
    pad = lambda c, v: _per_rank(
        lambda x: torch.nn.functional.pad(x, widths, value=v), c)
    return dataclasses.replace(
        state, k_cache=pad(state.k_cache, 0), v_cache=pad(state.v_cache, 0),
        k_scale=pad(state.k_scale, 1.0), v_scale=pad(state.v_scale, 1.0))


def _embed_token(params: Params, tok: torch.Tensor, pos: int,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B,) token ids at sequence position ``pos`` -> (B, E)."""
    x = params["vocab_embedding"]["table"][tok]
    return (x + params["pos_embedding"][pos]).to(compute_dtype)


# ---------------------------------------------------------------------------
# the per-op step
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, kT: torch.Tensor, vT: torch.Tensor,
                     bias: torch.Tensor | None, compute_dtype=torch.bfloat16,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     n_keys: int | None = None) -> torch.Tensor:
    """Single-query attention against a lane-major cache.

    q: (B, H, Dh); kT/vT: (B, H, Dh, T); bias: (B, T) additive or None; with
    int8 caches k_scale/v_scale (B, H, T) dequantize after the dots. Only the
    first ``n_keys`` positions are read (the rest must carry no weight).
    Where the switch of the cache's dtype is on and the head dim is one the
    kernels take on the device (``hd_takes``), K11 (caches in the compute
    dtype) or K12 (int8) computes it; else this plain path, whose softmax
    weights are rounded to the compute dtype before the V product (the
    kernels' are not). Returns (B, H, Dh) in the compute dtype.
    """
    if hd.use_kernel(kT.dtype) and hd.hd_takes(q.shape[-1], q.device) and (
            k_scale is not None or q.dtype == kT.dtype):
        if k_scale is None:
            return hd.decode_attention_hd(q.contiguous(), kT, vT, bias,
                                          n_keys=n_keys)
        return hd.decode_attention_hd_int8(q.contiguous(), kT, vT, k_scale,
                                           v_scale, bias, n_keys=n_keys)
    n = kT.shape[-1] if n_keys is None else n_keys
    cast = lambda a: a[..., :n].to(compute_dtype).float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhd,bhdt->bht", q.to(compute_dtype).float(),
                          cast(kT)) * scale
    if k_scale is not None:
        logits = logits * k_scale[..., :n]
    if bias is not None:
        logits = logits + bias[:, None, :n]
    w = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        w = w * v_scale[..., :n]
    out = torch.einsum("bht,bhdt->bhd", w.to(compute_dtype).float(), cast(vT))
    return out.to(compute_dtype)


def _grouped_cross_attention(qc: torch.Tensor, mem: MemoryKV, i: int,
                             group: int, compute_dtype=torch.bfloat16):
    """Cross-attention where G consecutive batch rows share one memory row:
    qc (B, H, Dh) with B = B_unique * G against layer ``i`` of the B_unique
    memory rows, the group folded into the query axis. Plain PyTorch (the
    JAX package computes it outside its kernels)."""
    bu = mem.k.shape[1]
    h, dh = qc.shape[1], qc.shape[2]
    q = qc.reshape(bu, group, h, dh).to(compute_dtype).float()
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bghd,bhdm->bghm", q,
                          mem.k[i].to(compute_dtype).float()) * scale
    if mem.k_scale is not None:
        logits = logits * mem.k_scale[i][:, None]
    logits = logits + mem.bias[:, None, None, :]
    w = torch.softmax(logits, dim=-1)
    if mem.v_scale is not None:
        w = w * mem.v_scale[i][:, None]
    out = torch.einsum("bghm,bhdm->bghd", w.to(compute_dtype).float(),
                       mem.v[i].to(compute_dtype).float())
    return out.reshape(bu * group, h, dh).to(compute_dtype)


def _decode_step_logits(params, cfg: DecoderConfig, x, t: int, caches,
                        mem, compute_dtype=torch.bfloat16,
                        mem_group: int = 1, tp_group=None) -> torch.Tensor:
    """Advance one token on the per-op step: x (B, E) = embedded token at
    position t-1. ``caches``: {"k", "v"[, "ks", "vs"]} lane-major arrays,
    written in place at column t-1. Returns (B, V) fp32 logits.

    With int8 caches and ``ACAI_PALLAS_DECODE_INT8`` on, where K12 / K13
    take the head dim on the device (``hd_takes``), the self-attention is
    K13 (quantize, append, attend) and the cross-attention with
    ``mem_group == 1`` is K12 over the stacked memory; otherwise the fresh
    k / v are quantized with fp32 scales, written, and attended by
    :func:`decode_attention` (its plain path where K12 does not take the
    head dim), as JAX's ``use_pallas`` falls back. ``mem_group > 1`` takes
    :func:`_grouped_cross_attention`. Caches in another float dtype than the
    compute dtype store the fresh k / v rounded to it; attention widens them.

    ``tp_group``: JAX's ``tp_axis`` step (Megatron tensor parallelism).
    ``params``, ``x``, ``caches`` and ``mem`` are then one entry per rank
    (:func:`prepare_tp_decode_params` shards; caches and memory over the
    rank's H / tp heads); each rank runs its heads and MLP columns, and the
    two row-parallel products (attention out, linear2) are summed across the
    ranks in the compute dtype by K15 ``tp_allreduce`` before their bias, as
    JAX's ``lax.psum`` of the dot. LayerNorms run on every rank; the
    logits come from rank 0's copy."""
    if tp_group is None:
        params, x, caches, mem = [params], [x], [caches], [mem]
    tp = len(params)
    e, dh = cfg.hidden_dim, cfg.head_dim
    e_loc, h = e // tp, cfg.num_heads // tp
    b = x[0].shape[0]
    pos = t - 1  # cache slot for this token's k/v
    quantized = "ks" in caches[0]
    fused_int8 = (quantized and hd.use_kernel(torch.int8)
                  and hd.hd_takes(dh, x[0].device))
    fused_mem = (mem_group == 1 and mem[0].k_scale is not None
                 and hd.use_kernel(torch.int8)
                 and hd.hd_takes(dh, x[0].device))
    cd = compute_dtype
    ranks = range(tp)

    def row_parallel(parts, out):
        """(B, E) compute-dtype partial products of each rank -> their sum
        plus the replicated bias (``out(r)``: rank r's dense params)."""
        if tp > 1:
            parts = tp_allreduce(parts, tp_group)
        return [y + out(r)["bias"].to(cd) for r, y in enumerate(parts)]

    def self_attention(r, i, q, k, v):
        c = caches[r]
        if fused_int8:
            return hd.self_attention_append_int8(
                q, k, v, c["k"], c["v"], c["ks"], c["vs"], i, pos)
        ks = vs = None
        if quantized:
            k, ks_new = quantize_rows(k)
            v, vs_new = quantize_rows(v)
            c["ks"][i, ..., pos] = ks_new
            c["vs"][i, ..., pos] = vs_new
            ks, vs = c["ks"][i], c["vs"][i]
        c["k"][i, ..., pos] = k.to(c["k"].dtype)
        c["v"][i, ..., pos] = v.to(c["v"].dtype)
        return decode_attention(q, c["k"][i], c["v"][i], None, cd, ks, vs,
                                n_keys=pos + 1)

    def cross_attention(r, i, qc):
        m = mem[r]
        if mem_group > 1:
            return _grouped_cross_attention(qc, m, i, mem_group, cd)
        if fused_mem:
            return hd.decode_attention_hd_int8(
                qc.contiguous(), m.k, m.v, m.k_scale, m.v_scale, m.bias,
                layer=i)
        return decode_attention(
            qc, m.k[i], m.v[i], m.bias, cd,
            None if m.k_scale is None else m.k_scale[i],
            None if m.v_scale is None else m.v_scale[i])

    for i in range(cfg.num_layers):
        blocks = [_layer(params[r]["blocks"], i) for r in ranks]
        parts = []
        for r in ranks:
            sa = blocks[r]["self_attn"]
            qkv = torch.matmul(x[r], sa["in_kernel"].to(cd)) \
                + sa["in_bias"].to(cd)
            q, k, v = (a.reshape(b, h, dh).contiguous()
                       for a in qkv.split(e_loc, dim=-1))
            attn = self_attention(r, i, q, k, v)
            parts.append(torch.matmul(attn.reshape(b, e_loc),
                                      sa["out"]["kernel"].to(cd)))
        y = row_parallel(parts, lambda r: blocks[r]["self_attn"]["out"])
        x = [nn.layernorm(blocks[r]["norm1"], x[r] + y[r], eps=1e-5)
             for r in ranks]

        parts = []
        for r in ranks:
            ca = blocks[r]["cross_attn"]
            qc = torch.matmul(x[r], ca["in_kernel"][:, :e_loc].to(cd)) \
                + ca["in_bias"][:e_loc].to(cd)
            cattn = cross_attention(r, i, qc.reshape(b, h, dh))
            parts.append(torch.matmul(cattn.reshape(b, e_loc),
                                      ca["out"]["kernel"].to(cd)))
        y = row_parallel(parts, lambda r: blocks[r]["cross_attn"]["out"])
        x = [nn.layernorm(blocks[r]["norm2"], x[r] + y[r], eps=1e-5)
             for r in ranks]

        parts = [torch.matmul(nn.gelu(nn.dense(blocks[r]["linear1"], x[r])),
                              blocks[r]["linear2"]["kernel"].to(cd))
                 for r in ranks]
        y = row_parallel(parts, lambda r: blocks[r]["linear2"])
        x = [nn.layernorm(blocks[r]["norm3"], x[r] + y[r], eps=1e-5)
             for r in ranks]
    out = nn.layernorm(params[0]["final_norm"], x[0], eps=1e-6)
    return nn.dense(params[0]["unembed"], out).float()


def _layer(p: Params, i: int) -> Params:
    """Layer ``i`` of a tree of stacked (L, ...) leaves."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in p.items()}


# ---------------------------------------------------------------------------
# one step, either layout
# ---------------------------------------------------------------------------

def step_logits(params, cfg: DecoderConfig, mono, state, mem,
                compute_dtype, pe_offset: int = 0, plain: bool = False,
                mem_group: int = 1, tp_group=None) -> torch.Tensor:
    """One decode step at position ``state.t``: appends the caches in place
    and returns (rows, V) fp32 logits. Time-major caches take the monolith
    step with the operands ``mono`` (:func:`_prepack_for`; ``plain`` runs
    its kernels' plain twins), lane-major ones the per-op step.
    ``state`` is a :class:`DecodeState` or a :class:`BeamState`, whose
    ``seqs`` are flattened to rows.

    ``tp_group``: a tensor-parallel step. ``params``, ``mono`` and ``mem``
    are one entry per rank and the state's caches are lists; the token is
    embedded once on rank 0 and handed to every rank, and the logits come
    from rank 0 (every rank holds the same x after each all-reduce)."""
    t = state.t
    seqs = state.seqs.reshape(-1, state.seqs.shape[-1])
    tp = tp_group is not None
    p0 = params[0] if tp else params
    x = _embed_token(p0, seqs[:, t - 1], t - 1 + pe_offset, compute_dtype)
    if tp:
        x = [x.to(d) for d in tp_group.devices]
    first = state.k_cache[0] if tp else state.k_cache
    if first.dim() == 5:
        caches = {"k": state.k_cache, "v": state.v_cache}
        if state.k_scale is not None:
            caches.update(ks=state.k_scale, vs=state.v_scale)
        if tp:  # one dict per rank
            caches = [dict(zip(caches, c)) for c in zip(*caches.values())]
        return _decode_step_logits(params, cfg, x, t, caches, mem,
                                   compute_dtype, mem_group, tp_group)
    each = (lambda f: [f(m) for m in mem]) if tp else (lambda f: f(mem))
    x = decode_layers(mono, x, t - 1, state.k_cache, state.v_cache,
                      each(lambda m: m.k), each(lambda m: m.v),
                      each(lambda m: m.bias),
                      cfg.num_heads // (tp_group.tp if tp else 1),
                      plain=plain, k_scale=state.k_scale,
                      v_scale=state.v_scale,
                      mem_k_scale=each(lambda m: m.k_scale),
                      mem_v_scale=each(lambda m: m.v_scale),
                      mem_group=mem_group, tp_group=tp_group)
    if tp:
        x = x[0]
    x = nn.layernorm(p0["final_norm"], x, eps=1e-6)
    return nn.dense(p0["unembed"], x).float()


# The operands of the latest _prepack_for calls, least recent first:
# [(key, leaves, operands)]. The key holds each decoder leaf's identity and
# version counter (an in-place update bumps it); the entry holds the leaves,
# so no identity in a live key can be taken by another tensor. A few are
# kept: a tensor-parallel decode packs one shard per rank.
_PREPACKED: list = []
_PREPACK_KEEP = 4


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def _prepack_for(params: Params, compute_dtype, cache_dtype,
                 tp_mono: bool = False) -> Params:
    """The monolith step's operands, their weights as
    :func:`..ops.decode_kernel.weight_quant_mode` says: int8 caches quantize
    them to int8 (W8A8, by default) or int4 (W4A8, ``ACAI_W4A8_DECODE``), or
    keep them in the compute dtype (``ACAI_W8A8_DECODE=0``); a
    tensor-parallel shard (``tp_mono``) keeps them in the compute dtype
    unless ``ACAI_TP_W8A8`` is on.

    The latest operands are kept and returned again while the same params,
    unchanged, are decoded with the same dtype and weight mode, so a server
    quantizes its weights once and not once per batch. Inference tensors
    (``torch.inference_mode``) keep no version counter and are packed anew
    on every call."""
    mode = weight_quant_mode(cache_dtype, tp_mono)
    leaves = _tensors(params)
    if any(t.is_inference() for t in leaves):
        return prepack(params, compute_dtype, quantize_weights=mode)
    key = (compute_dtype, mode, tuple((id(t), t._version) for t in leaves))
    for i, entry in enumerate(_PREPACKED):
        if entry[0] == key:
            _PREPACKED.append(_PREPACKED.pop(i))
            return entry[2]
    mono = prepack(params, compute_dtype, quantize_weights=mode)
    _PREPACKED[:] = _PREPACKED[1 - _PREPACK_KEEP:] + [(key, leaves, mono)]
    return mono


def sample_top_k(logits: torch.Tensor, sampling: SamplingConfig,
                 noise: torch.Tensor):
    """One sampled token per row from (B, V) fp32 logits: the top-k logits
    (ties: the lower index first), ``argmax(topk / temperature + noise)``
    with (B, k) Gumbel ``noise``; the log-prob is the untempered top-k
    ``log_softmax`` at the choice. Returns (tokens (B,), log_probs (B,))."""
    k = min(sampling.top_k, logits.shape[-1])
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, idx = order.values[:, :k], order.indices[:, :k]
    choice = torch.argmax(top / sampling.temperature + noise, dim=-1)
    tok = idx.gather(1, choice[:, None])[:, 0]
    lp = torch.log_softmax(top, dim=-1).gather(1, choice[:, None])[:, 0]
    return tok, lp


def _segment_budget(state, num_steps: int) -> int:
    """Steps one segment may take: up to ``num_steps``, the cache length and
    max_len."""
    return min(state.t + num_steps, state.seqs.shape[-1],
               cache_len_of(state.k_cache) + 1) - state.t


def _all_finished(state, i: int) -> bool:
    """The early exit of a segment, looked for every FINISH_CHECK_STEPS steps
    (each look makes the host wait for the card)."""
    return i % FINISH_CHECK_STEPS == 0 and bool(state.finished.all())


def _decode_step(params, cfg: DecoderConfig, mono, state: DecodeState, mem,
                 compute_dtype, pe_offset: int = 0,
                 sampling: SamplingConfig | None = None,
                 generator: torch.Generator | None = None,
                 mem_group: int = 1, tp_group=None) -> DecodeState:
    """One greedy or sampled token (one fresh draw of Gumbel noise from
    ``generator``) for every row, written at ``state.t``."""
    logits = step_logits(params, cfg, mono, state, mem, compute_dtype,
                         pe_offset, mem_group=mem_group, tp_group=tp_group)
    if sampling is None:
        next_tok = torch.argmax(logits, dim=-1)
        lp = torch.log_softmax(logits, dim=-1) \
            .gather(1, next_tok[:, None])[:, 0]
    else:
        k = min(sampling.top_k, logits.shape[-1])
        noise = nn.gumbel_noise((logits.shape[0], k), generator,
                                logits.device)
        next_tok, lp = sample_top_k(logits, sampling, noise)
    state.seqs[:, state.t] = next_tok
    state.log_probs[:, state.t] = lp
    state.finished |= next_tok == cfg.eos_idx
    state.t += 1
    return state


def decode_segment(params: Params, cfg: DecoderConfig, mono: Params | None,
                   state: DecodeState, mem: MemoryKV, num_steps: int,
                   compute_dtype=torch.bfloat16, pe_offset: int = 0,
                   sampling: SamplingConfig | None = None,
                   generator: torch.Generator | None = None,
                   mem_group: int = 1) -> DecodeState:
    """Run up to ``num_steps`` steps, greedy or sampled (one fresh draw of
    Gumbel noise per step from ``generator``); stops at the segment budget,
    the cache length or max_len, or once every row has finished."""
    for i in range(_segment_budget(state, num_steps)):
        if _all_finished(state, i):
            break
        state = _decode_step(params, cfg, mono, state, mem, compute_dtype,
                             pe_offset, sampling, generator, mem_group)
    return state


def _next_segment(cur: int, max_len: int, initial: int = 256) -> int:
    return min(max(initial, cur * 2), max_len)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def create_inference_mask(seqs: torch.Tensor, eos_idx: int) -> torch.Tensor:
    """True up to and including each row's first <eos>."""
    eos = seqs == eos_idx
    seen = torch.cumsum(eos.int(), dim=-1)
    return (seen == 0) | (eos & (seen == 1))


def mask_and_clip_seqs(seqs, log_probs, eos_idx: int, pad_idx: int):
    """Pad-fill junk after first <eos> and trim excess columns."""
    mask = create_inference_mask(seqs, eos_idx)
    seqs = torch.where(mask, seqs, pad_idx)
    log_probs = torch.where(mask, log_probs, 0.0)
    max_len = int(mask.sum(dim=-1).max())
    return seqs[:, :max_len], log_probs[:, :max_len], mask[:, :max_len]


def _compaction(finished: np.ndarray, g: int):
    """Rows to keep at a segment boundary, or None: the live rows (groups of
    ``g`` rows when the memory is grouped: a group is dropped only when all
    its rows finished) padded to a power of two by repeating the first live
    one, when that is at most half the current count. Returns (row
    selection, memory-row selection, finished mask of the kept rows, number
    of real rows kept)."""
    alive = np.flatnonzero(~finished.reshape(-1, g).all(axis=1))
    n = len(alive)
    target = max(1, 1 << (n - 1).bit_length()) if n else 1
    if not n or target > (len(finished) // g) // 2:
        return None
    groups = np.concatenate([alive, np.full(target - n, alive[0])])
    rows = (groups[:, None] * g + np.arange(g)).reshape(-1)
    fin = finished[rows].copy()
    fin[n * g:] = True  # pad rows cannot block the all-finished exit
    return rows, groups, fin, n * g


def _check_cache_dtype(cache_dtype) -> None:
    if cache_dtype != torch.int8 and not cache_dtype.is_floating_point:
        raise ValueError(f"caches are kept in a float dtype or in int8, got "
                         f"{cache_dtype}")


def _monolith_for(cfg: DecoderConfig, compute_dtype, cache_dtype,
                  max_len: int, mem_len: int, device, mem_group: int = 1,
                  tp: int = 1) -> bool:
    """Whether a decode takes the monolith step, decided once per decode:
    its switch is on, the caches are in the compute dtype or int8, and
    every kernel of the step takes the decoder's shapes on ``device`` up to
    the longest cache the decode can reach (``max_len`` rounded up to the
    time tile, where segment growth ends) and the memory's ``mem_len`` rows
    (:func:`..ops.decode_kernel.monolith_takes`). Otherwise the per-op step,
    as the JAX package's ``use_monolith`` (``pallas_monolith.py:419-443``)
    sends a float cache dtype other than the compute dtype, and the shapes
    its kernel does not take, to it."""
    if not (use_monolith() and cache_dtype in (compute_dtype, torch.int8)):
        return False
    return monolith_takes(cfg.hidden_dim, cfg.num_heads, cfg.mlp_dim,
                          cache_dtype, compute_dtype,
                          _round_up(max_len, time_tile(cache_dtype)), mem_len,
                          device, mem_group, tp)


def generate(params: Params, cfg: DecoderConfig, img_latent: torch.Tensor,
             latent_valid: torch.Tensor | None, *, max_len: int = 1536,
             sampling: SamplingConfig | None = None,
             generator: torch.Generator | None = None,
             initial_segment: int = 256, segment_steps: int | None = None,
             compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
             compact: bool = True, mem_group: int = 1, pe_offset: int = 0,
             progress_cb=None):
    """Batched KV-cached generation (greedy, or sampled with ``sampling``).

    Returns (seqs, log_probs, seq_mask) trimmed to the longest live sequence.
    ``cache_dtype=torch.int8`` decodes with int8 caches (and, on the monolith
    step, the weights of :func:`_prepack_for`). Sampling draws its Gumbel noise from ``generator``
    (a ``torch.Generator`` on the latent's device; seed 0 when None).

    ``mem_group=G > 1``: decode G sequences per row of ``img_latent`` (GRPO
    rollout groups) without replicating the memory: returns
    ``G * img_latent.shape[0]`` rows, group-major (row i*G+g is image i's
    g-th sequence), as decoding a ``repeat_interleave``-expanded latent
    would. int8 caches on the per-op step need the replicated memory: there
    the latent is repeated and the group becomes 1, as in JAX.

    ``progress_cb(seqs, t, finished)``: called at every segment boundary with
    host copies of the full master sequence buffer (B, max_len) (row order =
    input order; <bos> at column 0, pad tails), the decode position ``t`` and
    a (B,) finished mask (rows compacted away count as finished). Pass
    ``segment_steps`` (e.g. 25) for the granularity; with it, compaction
    fires at every boundary, not only at cache growth. After the last row
    finishes ``t`` may run up to FINISH_CHECK_STEPS - 1 steps past it.

    ``pe_offset=1`` reproduces the reference's cached-decode PE indexing
    (token ``seqs[:, t-1]`` embedded with ``pos_embedding[t]``); the default
    0 matches the training forward.

    A float ``cache_dtype`` other than the compute dtype (fp32 compute over
    bf16 caches, JAX's default) decodes on the per-op step with the caches
    stored in that dtype; so does a decoder whose shapes the monolith
    step's kernels do not take (:func:`_monolith_for`).
    """
    _check_cache_dtype(cache_dtype)
    monolith = _monolith_for(cfg, compute_dtype, cache_dtype, max_len,
                             img_latent.shape[1], img_latent.device,
                             mem_group)
    if mem_group > 1 and cache_dtype == torch.int8 and not monolith:
        img_latent = img_latent.repeat_interleave(mem_group, dim=0)
        if latent_valid is not None:
            latent_valid = latent_valid.repeat_interleave(mem_group, dim=0)
        mem_group = 1
    g = mem_group
    b = img_latent.shape[0] * g
    dev = img_latent.device
    tt = time_tile(cache_dtype) if monolith else 1
    cache_len = _round_up(min(initial_segment, max_len), tt)
    mem = precompute_memory_kv(params, cfg, img_latent, latent_valid,
                               compute_dtype, cache_dtype,
                               layout="te" if monolith else "hd")
    mono = _prepack_for(params, compute_dtype, cache_dtype) if monolith \
        else None
    state = init_decode_state(cfg, b, max_len, cache_len, cache_dtype, dev,
                              monolith)
    if sampling is not None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    # master per-original-row results; active rows map into it via row_map
    master_seqs = state.seqs.clone()
    master_lps = state.log_probs.clone()
    row_map = np.arange(b)

    steps = segment_steps or max_len  # default: until the cache is full
    t_known = 1
    while True:
        state = decode_segment(params, cfg, mono, state, mem, steps,
                               compute_dtype, pe_offset, sampling, generator,
                               g)
        rows = torch.as_tensor(row_map, device=dev)
        master_seqs[rows] = state.seqs[: len(row_map)]
        master_lps[rows] = state.log_probs[: len(row_map)]
        stop_bound = min(t_known + steps, cache_len_of(state.k_cache) + 1,
                         max_len)
        if stop_bound >= max_len:
            break
        t = t_known = state.t
        finished_rows = state.finished.cpu().numpy()
        if progress_cb is not None:
            fin_master = np.ones(b, bool)
            fin_master[row_map] = finished_rows[: len(row_map)]
            progress_cb(master_seqs.cpu().numpy(), t, fin_master)
        if t >= max_len or finished_rows.all():
            break
        keep = _compaction(finished_rows[: len(row_map)], g) if compact \
            else None
        if keep is not None:
            sel, sel_mem, fin, n_real = keep
            row_map = row_map[sel[:n_real]]
            sel = torch.as_tensor(sel, device=dev)
            pick = lambda a: None if a is None else a[:, sel].contiguous()
            state = DecodeState(
                state.seqs[sel], state.log_probs[sel],
                torch.as_tensor(fin, device=dev), state.t,
                pick(state.k_cache), pick(state.v_cache),
                pick(state.k_scale), pick(state.v_scale))
            mem = mem.rows(torch.as_tensor(sel_mem, device=dev))
        if t > cache_len_of(state.k_cache):
            state = grow_cache(state, _round_up(
                _next_segment(cache_len_of(state.k_cache), max_len), tt))

    return mask_and_clip_seqs(master_seqs, master_lps, cfg.eos_idx,
                              cfg.pad_idx)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BeamState:
    seqs: torch.Tensor       # (B, K, max_len) int64
    log_probs: torch.Tensor  # (B, K, max_len) float32 per-token lp
    scores: torch.Tensor     # (B, K) float32 cumulative lp
    finished: torch.Tensor   # (B, K) bool
    t: int
    k_cache: torch.Tensor    # (L, B*K, T_cache, E) or (L, B*K, H, Dh, T_cache)
    v_cache: torch.Tensor
    k_scale: torch.Tensor | None = None  # int8: per-position scales
    v_scale: torch.Tensor | None = None


def init_beam_state(cfg: DecoderConfig, batch_size: int, beam_size: int,
                    max_len: int, cache_len: int, cache_dtype=torch.bfloat16,
                    device="cpu", monolith: bool = True,
                    tp_devices=None) -> BeamState:
    b, k = batch_size, beam_size
    seqs = torch.full((b, k, max_len), cfg.pad_idx, dtype=torch.long,
                      device=device)
    seqs[:, :, 0] = cfg.bos_idx
    return BeamState(
        seqs, torch.zeros((b, k, max_len), dtype=torch.float32, device=device),
        torch.zeros((b, k), dtype=torch.float32, device=device),
        torch.zeros((b, k), dtype=torch.bool, device=device), 1,
        *_state_caches(cfg, b * k, cache_len, cache_dtype, device, monolith,
                       tp_devices))


def _beam_consts(cfg: DecoderConfig, b: int, k: int, dev):
    """The beam step's fixed masks for B images of K beams on ``dev``."""
    v = cfg.vocab_size
    return (torch.arange(v, device=dev) == cfg.pad_idx,
            (torch.arange(k, device=dev) > 0)[None, :, None],
            (torch.arange(b, device=dev) * k)[:, None])


def _beam_step(params, cfg: DecoderConfig, mono, s: BeamState, mem,
               compute_dtype, pe_offset: int, consts,
               tp_group=None) -> BeamState:
    """One beam-search step (see :func:`beam_decode_segment`); ``consts``
    from :func:`_beam_consts`."""
    b, k, _ = s.seqs.shape
    v = cfg.vocab_size
    vocab_is_pad, later_beam, row0 = consts
    logits = step_logits(params, cfg, mono, s, mem, compute_dtype,
                         pe_offset, mem_group=k, tp_group=tp_group)
    lp = torch.log_softmax(logits, dim=-1).view(b, k, v)
    cand = s.scores[:, :, None] + lp                           # (B, K, V)
    # finished beams extend only with <pad> at frozen score
    frozen = torch.where(vocab_is_pad, s.scores[:, :, None], nn.NEG_INF)
    cand = torch.where(s.finished[:, :, None], frozen, cand)
    if s.t == 1:  # all beams are identical <bos> rows: keep beam 0 only
        cand = torch.where(later_beam, nn.NEG_INF, cand)
    order = torch.sort(cand.view(b, k * v), dim=-1, descending=True,
                       stable=True)
    top_scores, top_idx = order.values[:, :k], order.indices[:, :k]
    parent = top_idx // v                                      # (B, K)
    token = top_idx % v

    def gather_beams(x2):                             # (B, K, ...) by parent
        idx = parent.view(parent.shape + (1,) * (x2.dim() - 2))
        return x2.gather(1, idx.expand(-1, -1, *x2.shape[2:]))

    seqs = gather_beams(s.seqs)
    seqs[:, :, s.t] = token
    log_probs = gather_beams(s.log_probs)
    log_probs[:, :, s.t] = top_scores - gather_beams(s.scores)
    finished = gather_beams(s.finished) | (token == cfg.eos_idx)
    flat_parent = (row0 + parent).view(b * k)
    pick = lambda a: _per_rank(
        lambda c: c.index_select(1, flat_parent.to(c.device)), a)
    return BeamState(seqs, log_probs, top_scores.contiguous(), finished,
                     s.t + 1, pick(s.k_cache), pick(s.v_cache),
                     pick(s.k_scale), pick(s.v_scale))


def beam_decode_segment(params: Params, cfg: DecoderConfig,
                        mono: Params | None, state: BeamState, mem: MemoryKV,
                        num_steps: int, compute_dtype=torch.bfloat16,
                        pe_offset: int = 0) -> BeamState:
    """Run up to ``num_steps`` beam-search steps.

    Each step scores all (K x V) continuations per image, keeps the top K by
    cumulative log-prob, and reorders the KV caches (and int8 scales) by
    gathering parent rows. Finished beams are frozen: their only continuation
    is <pad> at log-prob 0. Ties keep the lower candidate index first (a
    stable descending sort, the order of ``jax.lax.top_k``). ``mem`` holds
    one row per image (``mem_group = K``).
    """
    b, k, _ = state.seqs.shape
    consts = _beam_consts(cfg, b, k, state.seqs.device)
    for i in range(_segment_budget(state, num_steps)):
        if _all_finished(state, i):
            break
        state = _beam_step(params, cfg, mono, state, mem, compute_dtype,
                           pe_offset, consts)
    return state


def _select_best_beam(seqs, log_probs, scores, cfg, length_penalty: float):
    """GNMT length-normalized best-beam selection. Returns
    ((best_seqs, best_lps, mask), final_scores (B, K))."""
    b, k, _ = seqs.shape
    mask = create_inference_mask(seqs.view(b * k, -1), cfg.eos_idx)
    lengths = mask.view(b, k, -1).sum(dim=-1) - 1  # exclude <bos>
    norm = ((5.0 + lengths.float()) / 6.0) ** length_penalty
    final_scores = scores / norm.clamp_min(1e-6)
    best = torch.argmax(final_scores, dim=-1)               # (B,)
    rows = torch.arange(b, device=seqs.device)
    return (mask_and_clip_seqs(seqs[rows, best], log_probs[rows, best],
                               cfg.eos_idx, cfg.pad_idx), final_scores)


def beam_generate(params: Params, cfg: DecoderConfig, img_latent, latent_valid,
                  *, beam_size: int = 4, max_len: int = 1536,
                  length_penalty: float = 0.6, initial_segment: int = 256,
                  segment_steps: int | None = None,
                  compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                  return_all_beams: bool = False, pe_offset: int = 0):
    """Batched beam-search generation over the KV-cached decoder.

    Hypotheses are ranked in-loop by cumulative log-prob; the returned beam
    per row maximizes the GNMT length-normalized score
    ``lp / ((5 + len) / 6) ** length_penalty`` (``length_penalty=0`` selects
    by raw log-prob; ``beam_size=1`` is token-identical to greedy
    :func:`generate`). Returns ``(seqs, log_probs, mask)`` of the best beam,
    trimmed like :func:`generate`; with ``return_all_beams`` also returns
    ``(all_seqs, all_scores)``. Beams share their image's memory
    (``mem_group = beam_size``): the cross K/V are projected and held once
    per image. A float ``cache_dtype`` other than the compute dtype, or a
    shape the monolith step's kernels do not take, takes the per-op step,
    as in :func:`generate`.
    """
    _check_cache_dtype(cache_dtype)
    b = img_latent.shape[0]
    monolith = _monolith_for(cfg, compute_dtype, cache_dtype, max_len,
                             img_latent.shape[1], img_latent.device,
                             beam_size)
    tt = time_tile(cache_dtype) if monolith else 1
    cache_len = _round_up(min(initial_segment, max_len), tt)
    mem = precompute_memory_kv(params, cfg, img_latent, latent_valid,
                               compute_dtype, cache_dtype,
                               layout="te" if monolith else "hd")
    mono = _prepack_for(params, compute_dtype, cache_dtype) if monolith \
        else None
    state = init_beam_state(cfg, b, beam_size, max_len, cache_len,
                            cache_dtype, img_latent.device, monolith)
    steps = segment_steps or max_len
    t_known = 1
    while True:
        state = beam_decode_segment(params, cfg, mono, state, mem, steps,
                                    compute_dtype, pe_offset)
        stop_bound = min(t_known + steps, cache_len_of(state.k_cache) + 1,
                         max_len)
        if stop_bound >= max_len:
            break
        t = t_known = state.t
        if t >= max_len or bool(state.finished.all()):
            break
        if t > cache_len_of(state.k_cache):
            state = grow_cache(state, _round_up(
                _next_segment(cache_len_of(state.k_cache), max_len), tt))
    out, final_scores = _select_best_beam(state.seqs, state.log_probs,
                                          state.scores, cfg, length_penalty)
    if return_all_beams:
        return out + (state.seqs, final_scores)
    return out


def streamed_generate(params: Params, cfg: DecoderConfig, img_latent,
                      latent_valid, *, max_len: int = 1536,
                      flush_interval: int = 25, compute_dtype=torch.bfloat16,
                      pe_offset: int = 0, cache_dtype=None):
    """Greedy generation yielding token chunks every ``flush_interval`` steps.

    Yields ("step", (1, n) int64 numpy tokens) chunks, then a final
    ("finish", (seqs, log_probs, mask)). Single-image batches only; caches in
    the compute dtype, or in another float ``cache_dtype`` on the per-op
    step. The chunk in which the sequence finishes is not yielded as a step:
    the finish event carries the whole sequence.
    """
    if img_latent.shape[0] != 1:
        raise ValueError("Streamed generation only supports single image "
                         "batches")
    cache_dtype = compute_dtype if cache_dtype is None else cache_dtype
    if not cache_dtype.is_floating_point:
        raise ValueError(f"streamed generation keeps float caches, got "
                         f"{cache_dtype}")
    monolith = _monolith_for(cfg, compute_dtype, cache_dtype, max_len,
                             img_latent.shape[1], img_latent.device)
    tt = TIME_TILE if monolith else 1
    cache_len = _round_up(min(256, max_len), tt)
    mem = precompute_memory_kv(params, cfg, img_latent, latent_valid,
                               compute_dtype, cache_dtype,
                               layout="te" if monolith else "hd")
    mono = prepack(params, compute_dtype) if monolith else None
    state = init_decode_state(cfg, 1, max_len, cache_len, cache_dtype,
                              img_latent.device, monolith)
    start_t = 1
    done = False
    while not done and start_t < max_len:
        if start_t + flush_interval - 1 > cache_len_of(state.k_cache):
            state = grow_cache(state, _round_up(
                _next_segment(cache_len_of(state.k_cache), max_len), tt))
        state = decode_segment(params, cfg, mono, state, mem, flush_interval,
                               compute_dtype, pe_offset)
        t = state.t
        done = t >= max_len or bool(state.finished.all())
        new_tokens = state.seqs[:, start_t:t].cpu().numpy()
        start_t = t
        if not done:
            yield ("step", new_tokens)

    yield ("finish", mask_and_clip_seqs(state.seqs, state.log_probs,
                                        cfg.eos_idx, cfg.pad_idx))


# ---------------------------------------------------------------------------
# decode over a device mesh (data- and tensor-parallel)
# ---------------------------------------------------------------------------

def prepare_tp_decode_params(params: Params, cfg: DecoderConfig, mesh,
                             model_axis: str = "model") -> list:
    """Shuffle and split the decoder params for tensor-parallel decode once,
    and place each rank's piece on its device: ``[d][m]`` is the params of
    data coordinate d, model rank m (ranks that share a device share their
    tensors). Pass it as ``tp_params=`` when decoding repeatedly with the
    same weights (``batch_inference`` does, once per call)."""
    from ..parallel import sharding

    tp = mesh.shape[model_axis]
    pieces = sharding.tp_split_decoder_params(
        sharding.tp_shuffle_decoder_params(params, cfg.num_heads,
                                           cfg.head_dim, tp), tp)
    placed = {}

    def on(r, dev):
        if (r, dev) not in placed:
            placed[r, dev] = _to_device(pieces[r], dev)
        return placed[r, dev]

    return [[on(r, dev) for r, dev in enumerate(row)] for row in mesh.devices]


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _shard_memory(mem: MemoryKV, rows: slice, r: int, tp: int, dev,
                  layout: str) -> MemoryKV:
    """Rows ``rows`` of the memory, over model rank r's heads, on ``dev``:
    the last (lane) axis of the ``te`` layout, axis 2 of the ``hd`` one."""
    def cut(a):
        if a is None:
            return None
        a = a[:, rows]
        ax = a.dim() - 1 if layout == "te" else 2
        w = a.shape[ax] // tp
        return a.narrow(ax, r * w, w).contiguous().to(dev)

    return MemoryKV(cut(mem.k), cut(mem.v), mem.bias[rows].contiguous().to(dev),
                    cut(mem.k_scale), cut(mem.v_scale))


def _grow_sharded_caches(shards: list, new_len: int) -> None:
    """Cache-segment growth, the same for the whole mesh: every shard's
    caches (each rank's) padded to ``new_len``."""
    for sh in shards:
        sh.state = grow_cache(sh.state, new_len)


@dataclasses.dataclass
class _Shard:
    """One data coordinate of a meshed decode: its rows' state, and per model
    rank the params, monolith operands and memory (lists under tensor
    parallelism, single values otherwise)."""
    state: object
    params: object
    mono: object
    mem: object
    group: object = None
    generator: torch.Generator | None = None  # sampled decode
    beam_consts: tuple | None = None          # beam search
    done: bool = False


def _mesh_plan(cfg: DecoderConfig, mesh, axis, model_axis, compute_dtype,
               cache_dtype, what: str, *, max_len: int, mem_len: int,
               mem_group: int = 1):
    """(data shards, tp, monolith) of a meshed decode, with JAX's checks;
    the monolith step where :func:`_monolith_for` takes the rank's shapes
    on the mesh's devices."""
    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
    if axis != DATA_AXIS or model_axis not in (None, MODEL_AXIS):
        raise ValueError(f"a mesh's axes are {DATA_AXIS!r} and "
                         f"{MODEL_AXIS!r}, got {axis!r} and {model_axis!r}")
    _check_cache_dtype(cache_dtype)
    n_dev = mesh.shape[axis]
    tp = mesh.shape[model_axis] if model_axis is not None else 1
    if tp > 1 and (cfg.num_heads % tp or cfg.mlp_dim % tp):
        raise ValueError(f"tensor-parallel {what} needs num_heads "
                         f"({cfg.num_heads}) and mlp_dim ({cfg.mlp_dim}) "
                         f"divisible by the model axis size {tp}")
    # K15 takes 2 or 4 ranks on the card (its twin, on the CPU, any power
    # of two): a larger model axis over CUDA devices is refused up front
    if tp > 1 and tp not in (2, 4) and any(
            d.type == "cuda" for row in mesh.devices for d in row):
        raise ValueError(f"tensor-parallel {what} on CUDA takes a model "
                         f"axis of 2 or 4, got {tp}")
    # tp = 2 / 4 rides the monolith step with K15 (the JAX kernel's lane
    # conditions are TPU limits); other tp sizes (on the CPU) take the
    # per-op step
    monolith = (tp == 1 or tp in (2, 4)) and _monolith_for(
        cfg, compute_dtype, cache_dtype, max_len, mem_len, mesh.devices[0][0],
        mem_group, tp)
    return n_dev, tp, monolith


def _make_shards(params, cfg, mesh, n_dev, tp, mem, layout, monolith,
                 compute_dtype, cache_dtype, mem_rows, init_state, tp_params,
                 model_axis):
    """Each data shard's state (``init_state(its rank devices)``), params,
    operands and memory rows (``mem_rows`` a shard)."""
    if tp > 1 and tp_params is None:
        tp_params = prepare_tp_decode_params(params, cfg, mesh, model_axis)
    shards = []
    for d in range(n_dev):
        devs = mesh.devices[d][:tp]
        mrows = slice(d * mem_rows, (d + 1) * mem_rows)
        if tp > 1:
            p = tp_params[d]
            mems = [_shard_memory(mem, mrows, r, tp, devs[r], layout)
                    for r in range(tp)]
            mono = [_prepack_for(p[r], compute_dtype, cache_dtype, True)
                    for r in range(tp)] if monolith else None
            group = mesh.tp_group(d)
        else:
            p = _to_device(params, devs[0])
            mems = _shard_memory(mem, mrows, 0, 1, devs[0], layout)
            mono = _prepack_for(p, compute_dtype, cache_dtype) if monolith \
                else None
            group = None
        shards.append(_Shard(init_state(devs), p, mono, mems, group))
    return shards


def _lockstep_segment(shards: list, num_steps: int, max_len: int, step):
    """One segment of every shard in one host loop, token by token: a shard
    steps while it is below its segment budget (``num_steps``, its cache,
    max_len) and has a live row (looked for every FINISH_CHECK_STEPS steps,
    as in :func:`decode_segment`); ``step(shard)`` returns its next state."""
    stops = [min(sh.state.t + num_steps, max_len,
                 cache_len_of(sh.state.k_cache) + 1) for sh in shards]
    for i in range(max(stop - sh.state.t for sh, stop in zip(shards, stops))):
        for sh, stop in zip(shards, stops):
            if sh.done or sh.state.t >= stop:
                continue
            if i % FINISH_CHECK_STEPS == 0 and bool(sh.state.finished.all()):
                sh.done = True
                continue
            sh.state = step(sh)


def _mesh_loop(shards, steps, max_len, tt, step, progress_cb=None):
    """Segments until every shard has finished or max_len: after each, the
    merged status (and ``progress_cb``), then cache growth for the whole
    mesh when a live shard filled its cache."""
    cache_len = cache_len_of(shards[0].state.k_cache)
    while True:
        _lockstep_segment(shards, steps, max_len, step)
        t_all = [sh.state.t for sh in shards]
        if progress_cb is not None:
            fin_rows = np.concatenate([sh.state.finished.cpu().numpy()
                                       for sh in shards])
            seqs = np.concatenate([sh.state.seqs.cpu().numpy()
                                   for sh in shards])
            progress_cb(seqs, max(t_all), fin_rows)
        alive = [not (sh.done or bool(sh.state.finished.all()))
                 for sh in shards]
        if not any(alive):
            break
        t_max = max(t for t, a in zip(t_all, alive) if a)
        if t_max >= max_len:
            break
        if t_max > cache_len:
            cache_len = _round_up(_next_segment(cache_len, max_len), tt)
            _grow_sharded_caches(shards, cache_len)


def sharded_generate(params: Params, cfg: DecoderConfig, img_latent,
                     latent_valid, mesh, *, axis: str = "data",
                     model_axis: str | None = None, max_len: int = 1536,
                     sampling: SamplingConfig | None = None, seed: int = 0,
                     initial_segment: int = 256,
                     segment_steps: int | None = None,
                     compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                     mem_group: int = 1, tp_params=None, pe_offset: int = 0,
                     progress_cb=None):
    """Batch-sharded KV-cached generation over a :class:`..parallel.mesh.Mesh`.

    The twin of the JAX package's ``sharded_generate``: the rows are split
    over the ``axis`` (data) coordinates, and each data shard runs the whole
    decode on its rows. One host loop drives every shard in lock step, token
    by token; a shard stops stepping once all its rows have finished, cache
    growth is the same for the whole mesh (decided on the live shards), and
    no rows are compacted (it would desynchronise the shards' shapes).

    ``model_axis`` of size tp > 1 adds Megatron tensor parallelism: heads and
    MLP columns split over the model ranks (:func:`prepare_tp_decode_params`,
    or ``tp_params`` from it), three all-reduces per layer and step. tp = 2
    or 4 rides the monolith step (``decode_layers(tp_group=)``: K1 / K5
    partials, K15 ``tp_allreduce``) while its switch is on, with bf16 (or
    compute-dtype) weights unless ``ACAI_TP_W8A8``; with the switch off
    they take the per-op step (compute-dtype sums through K15). On the CPU
    any power of two takes the per-op step; on CUDA devices a model axis
    other than 2 or 4 raises ``ValueError`` (K15 takes 2 or 4 ranks).
    ``cfg.num_heads`` and ``cfg.mlp_dim`` must divide by tp, and the unique
    rows of ``img_latent`` by the data axis (pad the batch otherwise).

    With ``sampling``, shard d draws its noise from a generator seeded
    ``seed + d``, so sampled tokens differ from one device's. Returns
    (seqs, log_probs, mask) as :func:`generate`. ``progress_cb(seqs, t,
    finished)`` is called after every segment with the merged host copies
    (row order = input order) and ``t`` the largest position over all
    shards; rows of slower shards hold pad past their own position.
    """
    n_dev, tp, monolith = _mesh_plan(cfg, mesh, axis, model_axis,
                                     compute_dtype, cache_dtype, "decode",
                                     max_len=max_len,
                                     mem_len=img_latent.shape[1],
                                     mem_group=mem_group)
    if mem_group > 1 and cache_dtype == torch.int8 and not monolith:
        # grouped int8 memory is a monolith-step layout: the per-op step
        # needs the replicated memory
        img_latent = img_latent.repeat_interleave(mem_group, dim=0)
        if latent_valid is not None:
            latent_valid = latent_valid.repeat_interleave(mem_group, dim=0)
        mem_group = 1
    g = mem_group
    bu = img_latent.shape[0]
    if bu % n_dev:
        raise ValueError(f"batch of {bu} unique rows does not shard over "
                         f"{n_dev} devices: pad the batch")
    local_b = bu * g // n_dev
    tt = time_tile(cache_dtype) if monolith else 1
    cache_len = _round_up(min(initial_segment, max_len), tt)
    layout = "te" if monolith else "hd"
    mem = precompute_memory_kv(params, cfg, img_latent, latent_valid,
                               compute_dtype, cache_dtype, layout=layout)

    def init_state(devs):
        return init_decode_state(cfg, local_b, max_len, cache_len,
                                 cache_dtype, devs[0], monolith,
                                 devs if tp > 1 else None)

    shards = _make_shards(params, cfg, mesh, n_dev, tp, mem, layout,
                          monolith, compute_dtype, cache_dtype, bu // n_dev,
                          init_state, tp_params, model_axis)
    if sampling is not None:
        for d, sh in enumerate(shards):
            sh.generator = torch.Generator(
                device=sh.state.seqs.device).manual_seed(seed + d)

    def step(sh):
        return _decode_step(sh.params, cfg, sh.mono, sh.state, sh.mem,
                            compute_dtype, pe_offset, sampling, sh.generator,
                            g, sh.group)

    _mesh_loop(shards, segment_steps or max_len, max_len, tt, step,
               progress_cb)
    dev = shards[0].state.seqs.device
    cat = lambda xs: torch.cat([x.to(dev) for x in xs])
    return mask_and_clip_seqs(cat([sh.state.seqs for sh in shards]),
                              cat([sh.state.log_probs for sh in shards]),
                              cfg.eos_idx, cfg.pad_idx)


def sharded_beam_generate(params: Params, cfg: DecoderConfig, img_latent,
                          latent_valid, mesh, *, axis: str = "data",
                          model_axis: str | None = None, beam_size: int = 4,
                          max_len: int = 1536, length_penalty: float = 0.6,
                          initial_segment: int = 256,
                          segment_steps: int | None = None,
                          compute_dtype=torch.bfloat16,
                          cache_dtype=torch.bfloat16, tp_params=None,
                          pe_offset: int = 0):
    """Batch-sharded beam search over a mesh: the twin of the JAX package's
    ``sharded_beam_generate``. Each data shard runs the beam loop of
    :func:`beam_generate` on its images (beams share their image's memory,
    ``mem_group = beam_size``); beams only permute within an image, so the
    shards exchange nothing. ``model_axis`` adds tensor parallelism as in
    :func:`sharded_generate`. Returns the best beam per image as
    ``(seqs, log_probs, mask)``, as :func:`beam_generate`."""
    n_dev, tp, monolith = _mesh_plan(cfg, mesh, axis, model_axis,
                                     compute_dtype, cache_dtype, "beams",
                                     max_len=max_len,
                                     mem_len=img_latent.shape[1],
                                     mem_group=beam_size)
    b = img_latent.shape[0]
    k = beam_size
    if b % n_dev:
        raise ValueError(f"batch of {b} rows does not shard over {n_dev} "
                         f"devices: pad the batch")
    local_b = b // n_dev
    tt = time_tile(cache_dtype) if monolith else 1
    cache_len = _round_up(min(initial_segment, max_len), tt)
    layout = "te" if monolith else "hd"
    mem = precompute_memory_kv(params, cfg, img_latent, latent_valid,
                               compute_dtype, cache_dtype, layout=layout)

    def init_state(devs):
        return init_beam_state(cfg, local_b, k, max_len, cache_len,
                               cache_dtype, devs[0], monolith,
                               devs if tp > 1 else None)

    shards = _make_shards(params, cfg, mesh, n_dev, tp, mem, layout,
                          monolith, compute_dtype, cache_dtype, local_b,
                          init_state, tp_params, model_axis)
    for sh in shards:
        sh.beam_consts = _beam_consts(cfg, local_b, k, sh.state.seqs.device)

    def step(sh):
        return _beam_step(sh.params, cfg, sh.mono, sh.state, sh.mem,
                          compute_dtype, pe_offset, sh.beam_consts, sh.group)

    _mesh_loop(shards, segment_steps or max_len, max_len, tt, step)
    dev = shards[0].state.seqs.device
    cat = lambda xs: torch.cat([x.to(dev) for x in xs])
    out, _ = _select_best_beam(cat([sh.state.seqs for sh in shards]),
                               cat([sh.state.log_probs for sh in shards]),
                               cat([sh.state.scores for sh in shards]), cfg,
                               length_penalty)
    return out
