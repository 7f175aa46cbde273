"""KV-cached greedy decode -- the hot path of inference.

The twin of the JAX package's ``models/decode.py`` (greedy ``generate`` and
what it needs):

* Cross-attention K/V are projected once per batch from the stacked cross
  ``in_kernel`` kv columns (:func:`precompute_memory_kv`), in the time-major
  ``te`` layout ``(L, B, M, E)`` the decode-step kernels read.
* Caches are time-major ``(L, B, T, E)`` and appended in place by the step
  (:func:`..ops.decode_kernel.decode_layers`: K1/K2/K4 launches on CUDA).
* Segmented cache growth: the cache starts at ``initial_segment`` slots and
  grows (256, then doubling, capped at ``max_len``) only when a segment
  fills, so short sequences only ever touch short caches.
* Finished-row compaction at segment boundaries down to power-of-two row
  counts, so finished rows stop paying for cache bandwidth.
* The final norm, the unembedding and the argmax / log-softmax stay outside
  the layer kernels.

The token loop runs on the host; the all-finished early exit is checked every
``FINISH_CHECK_STEPS`` steps so the host does not wait on the card every
token (rows decode independently, so a few extra steps after every row has
finished change no kept token: :func:`mask_and_clip_seqs` masks them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import nn
from ..ops.decode_kernel import decode_layers, prepack
from .omr_decoder import DecoderConfig

Params = dict

# the cache time axis is kept a multiple of the JAX monolith's time tile so
# segment boundaries (and hence compaction points) fall where they do there
TIME_TILE = 16
FINISH_CHECK_STEPS = 16


@dataclasses.dataclass
class MemoryKV:
    """Per-layer cross-attention keys/values (L, B, M, E) and the (B, M)
    fp32 additive padding bias (0 valid / -1e9 padding)."""
    k: torch.Tensor
    v: torch.Tensor
    bias: torch.Tensor


@dataclasses.dataclass
class DecodeState:
    seqs: torch.Tensor       # (B, max_len) int64, pos 0 = <bos>
    log_probs: torch.Tensor  # (B, max_len) float32
    finished: torch.Tensor   # (B,) bool
    t: int                   # next position to fill
    k_cache: torch.Tensor    # (L, B, T_cache, E)
    v_cache: torch.Tensor    # (L, B, T_cache, E)


def precompute_memory_kv(params: Params, cfg: DecoderConfig,
                         img_latent: torch.Tensor,
                         latent_valid: torch.Tensor | None,
                         compute_dtype=torch.bfloat16,
                         cache_dtype=torch.bfloat16) -> MemoryKV:
    """Project encoder memory into per-layer cross K/V once per batch."""
    e = cfg.hidden_dim
    b, m = img_latent.shape[:2]
    ca = params["blocks"]["cross_attn"]
    mem = img_latent.to(compute_dtype)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        kv = torch.matmul(mem, ca["in_kernel"][i, :, e:].to(compute_dtype)) \
            + ca["in_bias"][i, e:].to(compute_dtype)
        ks.append(kv[..., :e].to(cache_dtype))
        vs.append(kv[..., e:].to(cache_dtype))
    if latent_valid is None:
        bias = torch.zeros((b, m), dtype=torch.float32, device=mem.device)
    else:
        bias = torch.where(latent_valid, 0.0, nn.NEG_INF).float()
    return MemoryKV(torch.stack(ks).contiguous(), torch.stack(vs).contiguous(),
                    bias.contiguous())


def init_decode_state(cfg: DecoderConfig, batch_size: int, max_len: int,
                      cache_len: int, cache_dtype=torch.bfloat16,
                      device="cpu") -> DecodeState:
    """Fresh decode state with <bos>-seeded sequences."""
    seqs = torch.full((batch_size, max_len), cfg.pad_idx, dtype=torch.long,
                      device=device)
    seqs[:, 0] = cfg.bos_idx
    shape = (cfg.num_layers, batch_size, cache_len, cfg.hidden_dim)
    return DecodeState(
        seqs, torch.zeros((batch_size, max_len), dtype=torch.float32,
                          device=device),
        torch.zeros((batch_size,), dtype=torch.bool, device=device), 1,
        torch.zeros(shape, dtype=cache_dtype, device=device),
        torch.zeros(shape, dtype=cache_dtype, device=device))


def grow_cache(state: DecodeState, new_cache_len: int) -> DecodeState:
    """Pad the KV caches with zeros to a longer segment."""
    cur = state.k_cache.shape[2]
    if new_cache_len <= cur:
        return state
    pad = lambda c: torch.nn.functional.pad(c, (0, 0, 0, new_cache_len - cur))
    return dataclasses.replace(state, k_cache=pad(state.k_cache),
                               v_cache=pad(state.v_cache))


def _embed_token(params: Params, tok: torch.Tensor, pos: int,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B,) token ids at sequence position ``pos`` -> (B, E)."""
    x = params["vocab_embedding"]["table"][tok]
    return (x + params["pos_embedding"][pos]).to(compute_dtype)


def step_logits(params: Params, cfg: DecoderConfig, mono: Params,
                state: DecodeState, mem: MemoryKV, compute_dtype,
                pe_offset: int = 0, plain: bool = False) -> torch.Tensor:
    """One decode step at position ``state.t``: appends the caches in place
    and returns (B, V) fp32 logits (``plain`` runs the kernels' plain twins)."""
    t = state.t
    x = _embed_token(params, state.seqs[:, t - 1], t - 1 + pe_offset,
                     compute_dtype)
    x = decode_layers(mono, x, t - 1, state.k_cache, state.v_cache, mem.k,
                      mem.v, mem.bias, cfg.num_heads, plain=plain)
    x = nn.layernorm(params["final_norm"], x, eps=1e-6)
    return nn.dense(params["unembed"], x).float()


def decode_segment(params: Params, cfg: DecoderConfig, mono: Params,
                   state: DecodeState, mem: MemoryKV, num_steps: int,
                   compute_dtype=torch.bfloat16,
                   pe_offset: int = 0) -> DecodeState:
    """Run up to ``num_steps`` greedy steps; stops at the segment budget, the
    cache length or max_len, or once every row has finished."""
    max_len = state.seqs.shape[1]
    cache_len = state.k_cache.shape[2]
    stop_t = min(state.t + num_steps, max_len, cache_len + 1)
    t0 = state.t
    while state.t < stop_t:
        if (state.t - t0) % FINISH_CHECK_STEPS == 0 \
                and bool(state.finished.all()):
            break
        logits = step_logits(params, cfg, mono, state, mem, compute_dtype,
                             pe_offset)
        next_tok = torch.argmax(logits, dim=-1)
        lp = torch.log_softmax(logits, dim=-1)
        state.seqs[:, state.t] = next_tok
        state.log_probs[:, state.t] = lp.gather(1, next_tok[:, None])[:, 0]
        state.finished |= next_tok == cfg.eos_idx
        state.t += 1
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


def generate(params: Params, cfg: DecoderConfig, img_latent: torch.Tensor,
             latent_valid: torch.Tensor | None, *, max_len: int = 1536,
             initial_segment: int = 256, compute_dtype=torch.bfloat16,
             cache_dtype=torch.bfloat16, pe_offset: int = 0):
    """Batched KV-cached greedy generation.

    Returns (seqs, log_probs, seq_mask) trimmed to the longest live sequence.
    ``pe_offset=1`` reproduces the reference's cached-decode PE indexing
    (token ``seqs[:, t-1]`` embedded with ``pos_embedding[t]``); the default
    0 matches the training forward.
    """
    if cache_dtype != compute_dtype:
        raise ValueError("the decode step keeps caches in the compute dtype")
    b = img_latent.shape[0]
    dev = img_latent.device
    cache_len = _round_up(min(initial_segment, max_len), TIME_TILE)
    mem = precompute_memory_kv(params, cfg, img_latent, latent_valid,
                               compute_dtype, cache_dtype)
    mono = prepack(params, compute_dtype)
    state = init_decode_state(cfg, b, max_len, cache_len, cache_dtype, dev)

    # master per-original-row results; active rows map into it via row_map
    master_seqs = state.seqs.clone()
    master_lps = state.log_probs.clone()
    row_map = np.arange(b)

    steps = max_len  # a segment runs until its cache is full
    t_known = 1
    while True:
        state = decode_segment(params, cfg, mono, state, mem, steps,
                               compute_dtype, pe_offset)
        rows = torch.as_tensor(row_map, device=dev)
        master_seqs[rows] = state.seqs[: len(row_map)]
        master_lps[rows] = state.log_probs[: len(row_map)]
        stop_bound = min(t_known + steps, state.k_cache.shape[2] + 1, max_len)
        if stop_bound >= max_len:
            break
        t = t_known = state.t
        finished_rows = state.finished.cpu().numpy()
        if t >= max_len or finished_rows.all():
            break
        # compaction: drop finished rows when the live ones fit a power of
        # two at most half the current batch
        sel = None
        unfinished = np.flatnonzero(~finished_rows[: len(row_map)])
        target_b = max(1, 1 << (len(unfinished) - 1).bit_length())
        if target_b <= len(row_map) // 2:
            pad_rows = np.full(target_b - len(unfinished), unfinished[0])
            sel = torch.as_tensor(np.concatenate([unfinished, pad_rows]),
                                  device=dev)
            # duplicate pad rows are marked finished so they cannot block
            # the all-finished early exit
            fin = torch.zeros((target_b,), dtype=torch.bool, device=dev)
            fin[len(unfinished):] = True
            row_map = row_map[unfinished]
        need_grow = t > state.k_cache.shape[2]
        if not (need_grow or sel is not None):
            continue
        if sel is not None:
            state = DecodeState(state.seqs[sel], state.log_probs[sel], fin,
                                state.t, state.k_cache[:, sel].contiguous(),
                                state.v_cache[:, sel].contiguous())
            mem = MemoryKV(mem.k[:, sel].contiguous(),
                           mem.v[:, sel].contiguous(),
                           mem.bias[sel].contiguous())
        if need_grow:
            state = grow_cache(state, _round_up(
                _next_segment(state.k_cache.shape[2], max_len), TIME_TILE))

    return mask_and_clip_seqs(master_seqs, master_lps, cfg.eos_idx,
                              cfg.pad_idx)
