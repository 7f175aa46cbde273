"""LMX transformer decoder, teacher-forced full-sequence forward.

The twin of the JAX package's ``models/omr_decoder.py``: learned token + 1-D
positional embeddings, post-norm decoder layers with cross-attention to the
encoder latent, unembedding to the 227-token LMX vocabulary. The KV-cached
greedy path lives in :mod:`.decode`; :func:`forward` is the dense
full-sequence forward of training (and the CPU oracle of the cached decode).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.tokenizer import LmxTokenizer
from ..ops import nn, transformer

Params = dict


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    max_lmx_seq_len: int = 1536
    vocab_size: int = 227
    num_layers: int = 12
    hidden_dim: int = 1024
    num_heads: int = 16
    mlp_dim: int = 4096
    dropout: float = 0.1
    pad_idx: int = 1
    bos_idx: int = 0
    eos_idx: int = 2

    @classmethod
    def from_tokenizer(cls, tok: LmxTokenizer, **kwargs) -> "DecoderConfig":
        return cls(vocab_size=tok.vocab_size, pad_idx=tok.pad_idx,
                   bos_idx=tok.bos_idx, eos_idx=tok.eos_idx, **kwargs)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads


def init_decoder_params(gen, cfg: DecoderConfig, dtype=torch.float32,
                        device="cpu") -> Params:
    return {
        "vocab_embedding": nn.embedding_init(gen, cfg.vocab_size,
                                             cfg.hidden_dim,
                                             pad_idx=cfg.pad_idx, dtype=dtype,
                                             device=device),
        "pos_embedding": nn.trunc_normal(
            gen, (cfg.max_lmx_seq_len, cfg.hidden_dim), std=0.1, dtype=dtype,
            device=device),
        "blocks": transformer.stack_init(transformer.decoder_layer_init, gen,
                                         cfg.num_layers, cfg.hidden_dim,
                                         cfg.mlp_dim, dtype, device),
        "final_norm": nn.layernorm_init(cfg.hidden_dim, dtype, device),
        "unembed": nn.dense_init(gen, cfg.hidden_dim, cfg.vocab_size, dtype,
                                 device),
    }


def embed_tokens(params: Params, seqs: torch.Tensor,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """(B, T) token ids -> (B, T, E) embeddings + positional slice."""
    t = seqs.shape[1]
    x = nn.embed(params["vocab_embedding"], seqs, compute_dtype)
    return x + params["pos_embedding"][:t].to(compute_dtype)[None]


def forward(params: Params, cfg: DecoderConfig, input_seqs: torch.Tensor,
            img_latent: torch.Tensor, lmx_valid: torch.Tensor | None,
            latent_valid: torch.Tensor | None, *,
            token_idxs_input: bool = True, compute_dtype=torch.float32,
            seeds=None, deterministic: bool = True,
            mem_kv: torch.Tensor | None = None,
            cross_group: int = 1) -> torch.Tensor:
    """Teacher-forced forward -> (B, T, V) fp32 logits.

    input_seqs: (B, T) right-shifted token ids, or (B, T, E) mixed embeddings
    when ``token_idxs_input=False`` (scheduled sampling feeds expected
    embeddings). Masks are validity masks (True = attend). ``mem_kv``:
    optional (L, B, Tm, 2E) precomputed cross K/V
    (:func:`..ops.transformer.precompute_memory_kv`), which scheduled sampling
    computes once for its two passes. ``seeds``: (seed0, seed1) of the
    dropout masks when ``deterministic`` is False. ``cross_group=G > 1``:
    input_seqs has B rows but img_latent / latent_valid / mem_kv carry the
    B/G unique memory rows (GRPO's rollouts of one image are contiguous).
    """
    if input_seqs.dim() == 2 and input_seqs.shape[1] > cfg.max_lmx_seq_len:
        raise ValueError(
            f"{input_seqs.shape[1]} long lmx sequence length is too long for "
            f"max sequence length of {cfg.max_lmx_seq_len}")
    if token_idxs_input:
        x = embed_tokens(params, input_seqs, compute_dtype)
    else:
        t = input_seqs.shape[1]
        x = input_seqs.to(compute_dtype) \
            + params["pos_embedding"][:t].to(compute_dtype)[None]
    b, t, _ = x.shape
    mem = img_latent.to(compute_dtype)
    if mem_kv is None:
        mem_kv = transformer.precompute_memory_kv(params["blocks"], mem)
    ones = lambda *s: torch.ones(s, dtype=torch.bool, device=x.device)
    x = transformer.decoder_stack(
        params["blocks"], x, mem_kv,
        ones(b, t) if lmx_valid is None else lmx_valid,
        ones(*mem.shape[:2]) if latent_valid is None else latent_valid,
        cfg.num_heads, cfg.dropout, seeds, deterministic, cross_group)
    x = nn.layernorm(params["final_norm"], x, eps=1e-6)
    return nn.dense(params["unembed"], x).float()


def batchify_and_split_lmx_seqs(lmx_seqs, pad_idx: int,
                                bucket_multiple: int = 128,
                                max_len: int | None = None):
    """Pad ragged LMX id sequences and split into (input, target, valid).

    input = seq[:-1], target = seq[1:], valid True where the *input* token is
    not padding. Pads to a static shape bucket (never past ``max_len``, the
    decoder's PE table, unless a real sequence is longer, which raises
    downstream)."""
    from .vit_encoder import bucket_len

    lens = [len(s) for s in lmx_seqs]
    tmax = bucket_len(max(lens) - 1, bucket_multiple)
    if max_len is not None:
        tmax = min(tmax, max(max_len, max(lens) - 1))
    b = len(lmx_seqs)
    inputs = np.full((b, tmax), pad_idx, dtype=np.int32)
    targets = np.full((b, tmax), pad_idx, dtype=np.int32)
    valid = np.zeros((b, tmax), dtype=bool)
    for i, s in enumerate(lmx_seqs):
        s = np.asarray(s, dtype=np.int32)
        n = len(s) - 1
        inputs[i, :n] = s[:-1]
        targets[i, :n] = s[1:]
        valid[i, :n] = True
    return inputs, targets, valid
