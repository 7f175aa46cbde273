"""KV-cached decode -- the hot path of inference.

The twin of the JAX package's ``models/decode.py`` on one card: greedy
:func:`generate`, :func:`beam_generate` and :func:`streamed_generate`, with
caches in the compute dtype or int8.

* Cross-attention K/V are projected once per batch from the stacked cross
  ``in_kernel`` kv columns (:func:`precompute_memory_kv`), in the time-major
  ``te`` layout ``(L, B, M, E)`` the decode-step kernels read.
* Caches are time-major ``(L, B, T, E)`` and appended in place by the step
  (:func:`..ops.decode_kernel.decode_layers`: kernel launches on CUDA).
* ``cache_dtype=torch.int8`` is the JAX monolith's quantized mode: int8 K/V
  with per (row, position, head) bf16 scales ``(L, B, T, H)``, quantized
  attention, and int8 weights with per-row quantized activations (W8A8).
  Tokens are near, not bit-identical, to compute-dtype decode.
* Segmented cache growth: the cache starts at ``initial_segment`` slots and
  grows (256, then doubling, capped at ``max_len``) only when a segment
  fills, so short sequences only ever touch short caches.
* Finished-row compaction at segment boundaries down to power-of-two row
  counts, so finished rows stop paying for cache bandwidth.
* Beams decode ``K`` rows per image over the un-replicated memory
  (``mem_group=K``); caches and scales are reordered by parent every step.
* The final norm, the unembedding and the argmax / log-softmax stay outside
  the layer kernels.

The token loop runs on the host; the all-finished early exit is checked every
``FINISH_CHECK_STEPS`` steps so the host does not wait on the card every
token (rows decode independently, so a few extra steps after every row has
finished change no kept token: :func:`mask_and_clip_seqs` masks them).

Not ported yet: sampled decode and ``generate(mem_group=)`` (the rollout
paths of GRPO training).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import nn
from ..ops.decode_kernel import decode_layers, prepack, quantize_rows
from .omr_decoder import DecoderConfig

Params = dict

# the cache time axis is kept a multiple of the JAX monolith's time tile so
# segment boundaries (and hence compaction points) fall where they do there
TIME_TILE = 16
INT8_TIME_TILE = 32
FINISH_CHECK_STEPS = 16
SCALE_DTYPE = torch.bfloat16


def time_tile(cache_dtype) -> int:
    return INT8_TIME_TILE if cache_dtype == torch.int8 else TIME_TILE


@dataclasses.dataclass
class MemoryKV:
    """Per-layer cross-attention keys/values (L, B, M, E) and the (B, M)
    fp32 additive padding bias (0 valid / -1e9 padding). int8 K/V carry
    (L, B, M, H) bf16 dequantization scales."""
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
    k_cache: torch.Tensor    # (L, B, T_cache, E)
    v_cache: torch.Tensor    # (L, B, T_cache, E)
    # int8 caches: per-written-position scales (L, B, T_cache, H) bf16
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


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
    quantized = cache_dtype == torch.int8
    cols = [[], [], [], []]  # k, v, k_scale, v_scale
    for i in range(cfg.num_layers):
        kv = torch.matmul(mem, ca["in_kernel"][i, :, e:].to(compute_dtype)) \
            + ca["in_bias"][i, e:].to(compute_dtype)
        for j, x in enumerate((kv[..., :e], kv[..., e:])):
            if quantized:
                q, s = quantize_rows(
                    x.float().reshape(b, m, cfg.num_heads, -1), SCALE_DTYPE)
                cols[j].append(q.reshape(b, m, e))
                cols[2 + j].append(s.to(SCALE_DTYPE))
            else:
                cols[j].append(x.to(cache_dtype))
    if latent_valid is None:
        bias = torch.zeros((b, m), dtype=torch.float32, device=mem.device)
    else:
        bias = torch.where(latent_valid, 0.0, nn.NEG_INF).float()
    stack = lambda c: torch.stack(c).contiguous() if c else None
    return MemoryKV(stack(cols[0]), stack(cols[1]), bias.contiguous(),
                    stack(cols[2]), stack(cols[3]))


def _init_caches(cfg: DecoderConfig, rows: int, cache_len: int, cache_dtype,
                 device):
    """Zero K/V caches (L, rows, cache_len, E); int8 caches come with
    all-ones scales (L, rows, cache_len, H)."""
    shape = (cfg.num_layers, rows, cache_len, cfg.hidden_dim)
    kv = [torch.zeros(shape, dtype=cache_dtype, device=device)
          for _ in range(2)]
    scales = [None, None]
    if cache_dtype == torch.int8:
        scales = [torch.ones(shape[:3] + (cfg.num_heads,), dtype=SCALE_DTYPE,
                             device=device) for _ in range(2)]
    return (*kv, *scales)


def init_decode_state(cfg: DecoderConfig, batch_size: int, max_len: int,
                      cache_len: int, cache_dtype=torch.bfloat16,
                      device="cpu") -> DecodeState:
    """Fresh decode state with <bos>-seeded sequences."""
    seqs = torch.full((batch_size, max_len), cfg.pad_idx, dtype=torch.long,
                      device=device)
    seqs[:, 0] = cfg.bos_idx
    return DecodeState(
        seqs, torch.zeros((batch_size, max_len), dtype=torch.float32,
                          device=device),
        torch.zeros((batch_size,), dtype=torch.bool, device=device), 1,
        *_init_caches(cfg, batch_size, cache_len, cache_dtype, device))


def grow_cache(state, new_cache_len: int):
    """Pad the KV caches with zeros, and int8 scales with ones, to a longer
    segment (``state``: a :class:`DecodeState` or a :class:`BeamState`)."""
    cur = state.k_cache.shape[2]
    if new_cache_len <= cur:
        return state
    pad = lambda c, v: None if c is None else torch.nn.functional.pad(
        c, (0, 0, 0, new_cache_len - cur), value=v)
    return dataclasses.replace(
        state, k_cache=pad(state.k_cache, 0), v_cache=pad(state.v_cache, 0),
        k_scale=pad(state.k_scale, 1.0), v_scale=pad(state.v_scale, 1.0))


def _embed_token(params: Params, tok: torch.Tensor, pos: int,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B,) token ids at sequence position ``pos`` -> (B, E)."""
    x = params["vocab_embedding"]["table"][tok]
    return (x + params["pos_embedding"][pos]).to(compute_dtype)


def step_logits(params: Params, cfg: DecoderConfig, mono: Params,
                state, mem: MemoryKV, compute_dtype,
                pe_offset: int = 0, plain: bool = False,
                mem_group: int = 1) -> torch.Tensor:
    """One decode step at position ``state.t``: appends the caches in place
    and returns (rows, V) fp32 logits (``plain`` runs the kernels' plain
    twins). ``state`` is a :class:`DecodeState` or a :class:`BeamState`,
    whose ``seqs`` are flattened to rows."""
    t = state.t
    seqs = state.seqs.reshape(-1, state.seqs.shape[-1])
    x = _embed_token(params, seqs[:, t - 1], t - 1 + pe_offset, compute_dtype)
    x = decode_layers(mono, x, t - 1, state.k_cache, state.v_cache, mem.k,
                      mem.v, mem.bias, cfg.num_heads, plain=plain,
                      k_scale=state.k_scale, v_scale=state.v_scale,
                      mem_k_scale=mem.k_scale, mem_v_scale=mem.v_scale,
                      mem_group=mem_group)
    x = nn.layernorm(params["final_norm"], x, eps=1e-6)
    return nn.dense(params["unembed"], x).float()


def _prepack_for(params: Params, compute_dtype, cache_dtype) -> Params:
    """The step's operands: int8 caches quantize the weights too (W8A8), as
    the JAX package's ``weight_quant_mode`` does by default."""
    return prepack(params, compute_dtype,
                   quantize_weights="int8" if cache_dtype == torch.int8
                   else False)


def _segment_budget(state, num_steps: int) -> int:
    """Steps one segment may take: up to ``num_steps``, the cache length and
    max_len."""
    return min(state.t + num_steps, state.seqs.shape[-1],
               state.k_cache.shape[2] + 1) - state.t


def _all_finished(state, i: int) -> bool:
    """The early exit of a segment, looked for every FINISH_CHECK_STEPS steps
    (each look makes the host wait for the card)."""
    return i % FINISH_CHECK_STEPS == 0 and bool(state.finished.all())


def decode_segment(params: Params, cfg: DecoderConfig, mono: Params,
                   state: DecodeState, mem: MemoryKV, num_steps: int,
                   compute_dtype=torch.bfloat16,
                   pe_offset: int = 0) -> DecodeState:
    """Run up to ``num_steps`` greedy steps; stops at the segment budget, the
    cache length or max_len, or once every row has finished."""
    for i in range(_segment_budget(state, num_steps)):
        if _all_finished(state, i):
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
             initial_segment: int = 256, segment_steps: int | None = None,
             compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
             compact: bool = True, pe_offset: int = 0, progress_cb=None):
    """Batched KV-cached greedy generation.

    Returns (seqs, log_probs, seq_mask) trimmed to the longest live sequence.
    ``cache_dtype=torch.int8`` decodes with int8 caches and W8A8 weights.

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
    """
    if cache_dtype not in (compute_dtype, torch.int8):
        raise ValueError("caches are kept in the compute dtype or in int8")
    b = img_latent.shape[0]
    dev = img_latent.device
    tt = time_tile(cache_dtype)
    cache_len = _round_up(min(initial_segment, max_len), tt)
    mem = precompute_memory_kv(params, cfg, img_latent, latent_valid,
                               compute_dtype, cache_dtype)
    mono = _prepack_for(params, compute_dtype, cache_dtype)
    state = init_decode_state(cfg, b, max_len, cache_len, cache_dtype, dev)

    # master per-original-row results; active rows map into it via row_map
    master_seqs = state.seqs.clone()
    master_lps = state.log_probs.clone()
    row_map = np.arange(b)

    steps = segment_steps or max_len  # default: until the cache is full
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
        if progress_cb is not None:
            fin_master = np.ones(b, bool)
            fin_master[row_map] = finished_rows[: len(row_map)]
            progress_cb(master_seqs.cpu().numpy(), t, fin_master)
        if t >= max_len or finished_rows.all():
            break
        # compaction: drop finished rows when the live ones fit a power of
        # two at most half the current batch
        sel = None
        unfinished = np.flatnonzero(~finished_rows[: len(row_map)])
        target_b = max(1, 1 << (len(unfinished) - 1).bit_length())
        if compact and target_b <= len(row_map) // 2:
            pad_rows = np.full(target_b - len(unfinished), unfinished[0])
            sel = torch.as_tensor(np.concatenate([unfinished, pad_rows]),
                                  device=dev)
            # duplicate pad rows are marked finished so they cannot block
            # the all-finished early exit
            fin = torch.zeros((target_b,), dtype=torch.bool, device=dev)
            fin[len(unfinished):] = True
            row_map = row_map[unfinished]
        need_grow = t > state.k_cache.shape[2]
        if sel is not None:
            pick = lambda a: None if a is None else a[:, sel].contiguous()
            state = DecodeState(state.seqs[sel], state.log_probs[sel], fin,
                                state.t, pick(state.k_cache),
                                pick(state.v_cache), pick(state.k_scale),
                                pick(state.v_scale))
            mem = mem.rows(sel)
        if need_grow:
            state = grow_cache(state, _round_up(
                _next_segment(state.k_cache.shape[2], max_len), tt))

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
    k_cache: torch.Tensor    # (L, B*K, T_cache, E)
    v_cache: torch.Tensor
    k_scale: torch.Tensor | None = None  # (L, B*K, T_cache, H) bf16
    v_scale: torch.Tensor | None = None


def init_beam_state(cfg: DecoderConfig, batch_size: int, beam_size: int,
                    max_len: int, cache_len: int, cache_dtype=torch.bfloat16,
                    device="cpu") -> BeamState:
    b, k = batch_size, beam_size
    seqs = torch.full((b, k, max_len), cfg.pad_idx, dtype=torch.long,
                      device=device)
    seqs[:, :, 0] = cfg.bos_idx
    return BeamState(
        seqs, torch.zeros((b, k, max_len), dtype=torch.float32, device=device),
        torch.zeros((b, k), dtype=torch.float32, device=device),
        torch.zeros((b, k), dtype=torch.bool, device=device), 1,
        *_init_caches(cfg, b * k, cache_len, cache_dtype, device))


def beam_decode_segment(params: Params, cfg: DecoderConfig, mono: Params,
                        state: BeamState, mem: MemoryKV, num_steps: int,
                        compute_dtype=torch.bfloat16,
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
    v = cfg.vocab_size
    dev = state.seqs.device
    vocab_is_pad = torch.arange(v, device=dev) == cfg.pad_idx
    later_beam = (torch.arange(k, device=dev) > 0)[None, :, None]
    row0 = (torch.arange(b, device=dev) * k)[:, None]
    for i in range(_segment_budget(state, num_steps)):
        if _all_finished(state, i):
            break
        s = state
        logits = step_logits(params, cfg, mono, s, mem, compute_dtype,
                             pe_offset, mem_group=k)
        lp = torch.log_softmax(logits, dim=-1).view(b, k, v)
        cand = s.scores[:, :, None] + lp                       # (B, K, V)
        # finished beams extend only with <pad> at frozen score
        frozen = torch.where(vocab_is_pad, s.scores[:, :, None], nn.NEG_INF)
        cand = torch.where(s.finished[:, :, None], frozen, cand)
        if s.t == 1:  # all beams are identical <bos> rows: keep beam 0 only
            cand = torch.where(later_beam, nn.NEG_INF, cand)
        order = torch.sort(cand.view(b, k * v), dim=-1, descending=True,
                           stable=True)
        top_scores, top_idx = order.values[:, :k], order.indices[:, :k]
        parent = top_idx // v                                  # (B, K)
        token = top_idx % v

        def gather_beams(x2):                         # (B, K, ...) by parent
            idx = parent.view(parent.shape + (1,) * (x2.dim() - 2))
            return x2.gather(1, idx.expand(-1, -1, *x2.shape[2:]))

        seqs = gather_beams(s.seqs)
        seqs[:, :, s.t] = token
        log_probs = gather_beams(s.log_probs)
        log_probs[:, :, s.t] = top_scores - gather_beams(s.scores)
        finished = gather_beams(s.finished) | (token == cfg.eos_idx)
        flat_parent = (row0 + parent).view(b * k)
        pick = lambda a: None if a is None else a.index_select(1, flat_parent)
        state = BeamState(seqs, log_probs, top_scores.contiguous(), finished,
                          s.t + 1, pick(s.k_cache), pick(s.v_cache),
                          pick(s.k_scale), pick(s.v_scale))
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
    per image.
    """
    if cache_dtype not in (compute_dtype, torch.int8):
        raise ValueError("caches are kept in the compute dtype or in int8")
    b = img_latent.shape[0]
    tt = time_tile(cache_dtype)
    cache_len = _round_up(min(initial_segment, max_len), tt)
    mem = precompute_memory_kv(params, cfg, img_latent, latent_valid,
                               compute_dtype, cache_dtype)
    mono = _prepack_for(params, compute_dtype, cache_dtype)
    state = init_beam_state(cfg, b, beam_size, max_len, cache_len,
                            cache_dtype, img_latent.device)
    steps = segment_steps or max_len
    t_known = 1
    while True:
        state = beam_decode_segment(params, cfg, mono, state, mem, steps,
                                    compute_dtype, pe_offset)
        stop_bound = min(t_known + steps, state.k_cache.shape[2] + 1, max_len)
        if stop_bound >= max_len:
            break
        t = t_known = state.t
        if t >= max_len or bool(state.finished.all()):
            break
        if t > state.k_cache.shape[2]:
            state = grow_cache(state, _round_up(
                _next_segment(state.k_cache.shape[2], max_len), tt))
    out, final_scores = _select_best_beam(state.seqs, state.log_probs,
                                          state.scores, cfg, length_penalty)
    if return_all_beams:
        return out + (state.seqs, final_scores)
    return out


def streamed_generate(params: Params, cfg: DecoderConfig, img_latent,
                      latent_valid, *, max_len: int = 1536,
                      flush_interval: int = 25, compute_dtype=torch.bfloat16,
                      pe_offset: int = 0):
    """Greedy generation yielding token chunks every ``flush_interval`` steps.

    Yields ("step", (1, n) int64 numpy tokens) chunks, then a final
    ("finish", (seqs, log_probs, mask)). Single-image batches only; caches in
    the compute dtype. The chunk in which the sequence finishes is not
    yielded as a step: the finish event carries the whole sequence.
    """
    if img_latent.shape[0] != 1:
        raise ValueError("Streamed generation only supports single image "
                         "batches")
    cache_len = _round_up(min(256, max_len), TIME_TILE)
    mem = precompute_memory_kv(params, cfg, img_latent, latent_valid,
                               compute_dtype, compute_dtype)
    mono = prepack(params, compute_dtype)
    state = init_decode_state(cfg, 1, max_len, cache_len, compute_dtype,
                              img_latent.device)
    start_t = 1
    done = False
    while not done and start_t < max_len:
        if start_t + flush_interval - 1 > state.k_cache.shape[2]:
            state = grow_cache(state, _round_up(
                _next_segment(state.k_cache.shape[2], max_len), TIME_TILE))
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
