"""LMX transformer decoder, teacher-forced full-sequence forward.

The twin of the JAX package's ``models/omr_decoder.py``: learned token + 1-D
positional embeddings, post-norm decoder layers with cross-attention to the
encoder latent, unembedding to the 227-token LMX vocabulary. The KV-cached
greedy path lives in :mod:`.decode`; :func:`forward` is its plain CPU oracle.
"""

from __future__ import annotations

import dataclasses

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
    x = params["vocab_embedding"]["table"].to(compute_dtype)[seqs.long()]
    return x + params["pos_embedding"][:t].to(compute_dtype)[None]


def forward(params: Params, cfg: DecoderConfig, input_seqs: torch.Tensor,
            img_latent: torch.Tensor, lmx_valid: torch.Tensor | None,
            latent_valid: torch.Tensor | None,
            compute_dtype=torch.float32) -> torch.Tensor:
    """Teacher-forced forward: (B, T) right-shifted ids -> (B, T, V) fp32
    logits. Masks are validity masks (True = attend)."""
    if input_seqs.shape[1] > cfg.max_lmx_seq_len:
        raise ValueError(
            f"{input_seqs.shape[1]} long lmx sequence length is too long for "
            f"max sequence length of {cfg.max_lmx_seq_len}")
    x = embed_tokens(params, input_seqs, compute_dtype)
    t = x.shape[1]
    self_bias = nn.causal_bias(t, x.device)
    if lmx_valid is not None:
        self_bias = self_bias + nn.valid_to_bias(lmx_valid)
    cross_bias = (nn.valid_to_bias(latent_valid)
                  if latent_valid is not None else None)
    x = transformer.decoder_stack(params["blocks"], x,
                                  img_latent.to(compute_dtype), self_bias,
                                  cross_bias, cfg.num_heads)
    x = nn.layernorm(params["final_norm"], x, eps=1e-6)
    return nn.dense(params["unembed"], x).float()
