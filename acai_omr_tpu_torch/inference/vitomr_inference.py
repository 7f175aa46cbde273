"""Inference set-up: the flagship configuration, its weights, the tokenizer
and the image transform.

The twin of ``set_up_omr_inference`` in the JAX package's
``inference/vitomr_inference.py``; weights come from a numpy ``.npz`` of the
JAX parameter tree or are drawn from a seed.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..config import (LMX_VOCAB_PATH, MAX_LMX_SEQ_LEN, NUM_DECODER_LAYERS,
                      OMR_MAX_IMG_SEQ_LEN, PATCH_SIZE, PE_MAX_HEIGHT,
                      PE_MAX_WIDTH, ENCODER_FINE_TUNE_DEPTH)
from ..data import transforms as tf_lib
from ..data.tokenizer import LmxTokenizer
from ..models import vitomr as vitomr_lib
from ..models.omr_decoder import DecoderConfig
from ..models.vit_encoder import EncoderConfig
from ..models.vitomr import ViTOMRConfig
from ..models.weights import load_npz


def flagship_config(tokenizer: LmxTokenizer) -> ViTOMRConfig:
    """The seq2seq ViTOMR the JAX package trains and serves (its
    ``train/omr_teacher_force_train.set_up_vitomr``): ViT-B/16 encoder
    (12 x 768, 12 heads), 4096-wide transition head, 12 x 1024 decoder with
    16 heads and F = 4096 over the 227-token LMX vocabulary."""
    return ViTOMRConfig(
        encoder=EncoderConfig(patch_size=PATCH_SIZE, pe_max_height=PE_MAX_HEIGHT,
                              pe_max_width=PE_MAX_WIDTH, dropout=0.05,
                              fine_tune_depth=ENCODER_FINE_TUNE_DEPTH),
        decoder=DecoderConfig.from_tokenizer(
            tokenizer, max_lmx_seq_len=MAX_LMX_SEQ_LEN,
            num_layers=NUM_DECODER_LAYERS, dropout=0.1),
        transition_head_dropout=0.05)


def set_up_omr_inference(weights_path: str | None = None,
                         compute_dtype=torch.bfloat16, device=None,
                         seed: int = 0):
    """(cfg, params, tokenizer, base_img_transform) on ``device`` (``cuda``
    unless the caller passes ``device="cpu"``). Weights load from a numpy
    ``.npz`` of the JAX parameter tree when given, else are drawn from
    ``seed`` (architecture-only use)."""
    device = resolve_device(device)
    tokenizer = LmxTokenizer(LMX_VOCAB_PATH)
    cfg = flagship_config(tokenizer)
    if weights_path:
        params = load_npz(weights_path, device=device, dtype=compute_dtype)
    else:
        params = vitomr_lib.init_vitomr_params(cfg, seed, compute_dtype,
                                               device)
    base_img_transform = tf_lib.Compose([
        tf_lib.to_float_chw,
        tf_lib.DynamicResize(PATCH_SIZE, OMR_MAX_IMG_SEQ_LEN, PE_MAX_HEIGHT,
                             PE_MAX_WIDTH, crop_imgs=False),
    ])
    return cfg, params, tokenizer, base_img_transform

