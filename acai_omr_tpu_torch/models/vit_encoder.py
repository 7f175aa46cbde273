"""ViT encoder over ragged multi-resolution sheet-music images.

The twin of the JAX package's ``models/vit_encoder.py`` (without its MAE
masking):

* :func:`batchify` is a host-side packer (numpy) that emits fixed-shape
  arrays padded to a shape bucket plus gather indices into the 2-D PE grid;
* PE slice *and* bilinear interpolation are one device gather
  (:func:`..ops.pe.gather_pe`), so a batch can mix in-grid and oversize images;
* :func:`encode` runs the post-norm stack through the kernel path on CUDA and
  ends in a final LayerNorm with eps 1e-6; in training it applies dropout,
  runs the frozen prefix of layers without saves and cuts the gradient
  after it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import nn, transformer
from ..ops import patchify as patch_ops
from ..ops import pe as pe_ops

Params = dict


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    patch_size: int = 16
    pe_max_height: int = 60
    pe_max_width: int = 200
    num_layers: int = 12
    hidden_dim: int = 768
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout: float = 0.0
    num_channels: int = 1
    # frozen/fine-tune split of seq2seq training; inference runs every layer
    fine_tune_depth: int = 0

    @property
    def patch_dim(self) -> int:
        return self.num_channels * self.patch_size ** 2


def init_encoder_params(gen, cfg: EncoderConfig, dtype=torch.float32,
                        device="cpu") -> Params:
    return {
        "pos_embedding": nn.trunc_normal(
            gen, (cfg.pe_max_height, cfg.pe_max_width, cfg.hidden_dim),
            std=0.1, dtype=dtype, device=device),
        "projection": nn.dense_init(gen, cfg.patch_dim, cfg.hidden_dim, dtype,
                                    device),
        "blocks": transformer.stack_init(transformer.encoder_layer_init, gen,
                                         cfg.num_layers, cfg.hidden_dim,
                                         cfg.mlp_dim, dtype, device),
        "final_norm": nn.layernorm_init(cfg.hidden_dim, dtype, device),
    }


# ---------------------------------------------------------------------------
# host-side ragged packing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PatchBatch:
    """Fixed-shape view of a ragged image batch (host numpy arrays)."""
    patches: np.ndarray      # (B, L, P*P*C) float32
    pe_idx: np.ndarray       # (B, L, 4) int32 gather indices into pe grid
    pe_w: np.ndarray         # (B, L, 4) float32 gather weights
    valid: np.ndarray        # (B, L) bool, True = real patch
    lengths: np.ndarray      # (B,) int32 true sequence lengths
    dims: list               # [(hp, wp)] per image

    def to(self, device) -> tuple:
        """(patches, pe_idx, pe_w, valid) as tensors on ``device``."""
        return tuple(torch.from_numpy(a).to(device) for a in
                     (self.patches, self.pe_idx, self.pe_w, self.valid))


def bucket_len(n: int, multiple: int = 128, minimum: int | None = None) -> int:
    if minimum is None:
        minimum = multiple
    return max(minimum, -(-n // multiple) * multiple)


def batchify(imgs, cfg: EncoderConfig, bucket_multiple: int = 128,
             allow_interpolation: bool = True) -> PatchBatch:
    """Pack a list of (C, H, W) float arrays into one static-shape batch.

    ``allow_interpolation=False`` rejects images beyond the PE grid; True
    bilinearly resizes the PE grid for them.
    """
    p = cfg.patch_size
    per_img = []
    for img in imgs:
        img = np.asarray(img, dtype=np.float32)
        if img.ndim == 2:
            img = img[None]
        hp, wp = img.shape[-2] // p, img.shape[-1] // p
        if (hp > cfg.pe_max_height or wp > cfg.pe_max_width) \
                and not allow_interpolation:
            raise ValueError(
                f"{hp} x {wp} image is too large for max positional embedding "
                f"grid of shape {cfg.pe_max_height} x {cfg.pe_max_width}")
        patches = patch_ops.patchify(img, p)
        idx, w = pe_ops.pe_indices(hp, wp, cfg.pe_max_height, cfg.pe_max_width)
        per_img.append((patches, idx, w, (hp, wp)))

    b = len(per_img)
    lmax = bucket_len(max(x[0].shape[0] for x in per_img), bucket_multiple)
    patches = np.zeros((b, lmax, cfg.patch_dim), dtype=np.float32)
    pe_idx = np.zeros((b, lmax, 4), dtype=np.int32)
    pe_w = np.zeros((b, lmax, 4), dtype=np.float32)
    valid = np.zeros((b, lmax), dtype=bool)
    lengths = np.zeros((b,), dtype=np.int32)
    dims = []
    for i, (pt, idx, w, hw) in enumerate(per_img):
        n = pt.shape[0]
        patches[i, :n] = pt
        pe_idx[i, :n] = idx
        pe_w[i, :n] = w
        valid[i, :n] = True
        lengths[i] = n
        dims.append(hw)
    return PatchBatch(patches, pe_idx, pe_w, valid, lengths, dims)


# ---------------------------------------------------------------------------
# device-side forward
# ---------------------------------------------------------------------------

def embed_patches(params: Params, patches: torch.Tensor, pe_idx: torch.Tensor,
                  pe_w: torch.Tensor, valid: torch.Tensor,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Project patches to the hidden dim and add gathered 2-D PEs; padded
    rows are zeroed."""
    x = nn.dense(params["projection"], patches.to(compute_dtype))
    x = x + pe_ops.gather_pe(params["pos_embedding"].to(compute_dtype),
                             pe_idx, pe_w)
    return torch.where(valid[..., None], x, torch.zeros_like(x))


def encode(params: Params, cfg: EncoderConfig, patches, pe_idx, pe_w, valid,
           compute_dtype=torch.float32, seeds=None, deterministic: bool = True,
           frozen_stop_gradient: bool = False):
    """Encoder forward on a packed batch -> (latent (B, L, E), valid (B, L)).

    With ``frozen_stop_gradient=True`` gradients are cut after the frozen
    prefix of ``num_layers - fine_tune_depth`` layers (``fine_tune_depth=0``
    then means the whole encoder is frozen, matching
    :func:`..parallel.trainer.encoder_llrd_scales`); the prefix runs without
    dropout and, needing no gradient, without saves. ``seeds``: (seed0, seed1)
    of the dropout masks when ``deterministic`` is False.
    """
    x = embed_patches(params, patches, pe_idx, pe_w, valid, compute_dtype)
    blocks, n, heads = params["blocks"], cfg.num_layers, cfg.num_heads
    n_frozen = n - cfg.fine_tune_depth \
        if (cfg.fine_tune_depth or frozen_stop_gradient) else 0
    if 0 < n_frozen:
        frozen = transformer.stack_slice(blocks, 0, min(n_frozen, n))
        if frozen_stop_gradient:
            with torch.no_grad():
                x = transformer.encoder_stack(frozen, x, valid, heads)
        else:
            x = transformer.encoder_stack(frozen, x, valid, heads)
    if n_frozen < n:
        tune = transformer.stack_slice(blocks, max(n_frozen, 0), n)
        x = transformer.encoder_stack(tune, x, valid, heads, cfg.dropout,
                                      seeds, deterministic)
    return nn.layernorm(params["final_norm"], x, eps=1e-6), valid
