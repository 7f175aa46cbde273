"""ViTOMR: ViT encoder -> transition head -> LMX decoder (inference half).

The twin of the JAX package's ``models/vitomr.py``: one parameter dict with
the JAX tree's names and layouts, and the pure forward functions the greedy
inference path needs.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..ops import nn
from . import omr_decoder, vit_encoder
from .omr_decoder import DecoderConfig
from .vit_encoder import EncoderConfig

Params = dict


@dataclasses.dataclass(frozen=True)
class ViTOMRConfig:
    encoder: EncoderConfig = dataclasses.field(
        default_factory=lambda: EncoderConfig(dropout=0.05, fine_tune_depth=12))
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    transition_head_dim: int = 4096
    transition_head_dropout: float = 0.05


def init_vitomr_params(cfg: ViTOMRConfig, seed: int = 0, dtype=torch.float32,
                       device=None) -> Params:
    """Random parameters at ``cfg``'s shapes, drawn from ``seed`` with an
    explicit ``torch.Generator`` (same distributions as the JAX init).
    Runs on ``cuda`` unless ``device`` says otherwise."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return {
        "encoder": vit_encoder.init_encoder_params(gen, cfg.encoder, dtype,
                                                   device),
        "transition_head": {
            "linear1": nn.dense_init(gen, cfg.encoder.hidden_dim,
                                     cfg.transition_head_dim, dtype, device),
            "linear2": nn.dense_init(gen, cfg.transition_head_dim,
                                     cfg.decoder.hidden_dim, dtype, device),
        },
        "decoder": omr_decoder.init_decoder_params(gen, cfg.decoder, dtype,
                                                   device),
    }


def transition_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Linear(768->4096) -> GELU -> Linear(4096->1024) (dropout is off at
    inference)."""
    return nn.dense(params["linear2"], nn.gelu(nn.dense(params["linear1"], x)))


def encode_image(params: Params, cfg: ViTOMRConfig, patches, pe_idx, pe_w,
                 valid, *, compute_dtype=torch.float32):
    """Encoder + transition head -> (img_latent (B, L, E_dec), latent_valid)."""
    latent, latent_valid = vit_encoder.encode(
        params["encoder"], cfg.encoder, patches, pe_idx, pe_w, valid,
        compute_dtype=compute_dtype)
    return transition_head(params["transition_head"], latent), latent_valid
