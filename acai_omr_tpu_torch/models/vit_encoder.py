"""ViT encoder over ragged multi-resolution sheet-music images.

The twin of the JAX package's ``models/vit_encoder.py``:

* :func:`batchify` is a host-side packer (numpy) that emits fixed-shape
  arrays padded to a shape bucket plus gather indices into the 2-D PE grid;
* PE slice *and* bilinear interpolation are one device gather
  (:func:`..ops.pe.gather_pe`), so a batch can mix in-grid and oversize images;
* :func:`encode` runs the post-norm stack through the kernel path on CUDA and
  ends in a final LayerNorm with eps 1e-6; in training it applies dropout,
  runs the frozen prefix of layers without saves and cuts the gradient
  after it;
* :func:`mae_mask` / :func:`gather_kept` are the per-example random masking
  of MAE pretraining as two stable argsorts and a gather over static shapes.
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


# ---------------------------------------------------------------------------
# MAE masking (device-side, static shapes)
# ---------------------------------------------------------------------------

def mae_keep_len(length, mask_ratio: float) -> np.ndarray:
    """len_keep = int(L * (1 - mask_ratio)), in float64 on the host."""
    return (np.asarray(length) * (1.0 - mask_ratio)).astype(np.int32)


@dataclasses.dataclass
class MaeMask:
    """Device tensors describing one batch's random masking."""
    ids_keep: torch.Tensor      # (B, K) indices of kept patches (into 0..L)
    kept_valid: torch.Tensor    # (B, K) True where a real kept patch
    ids_restore: torch.Tensor   # (B, L) inverse shuffle permutation
    seq_mask: torch.Tensor      # (B, L) True = patch was masked out
    keep_lengths: torch.Tensor  # (B,) number of kept patches per example


def mae_mask(valid: torch.Tensor, lengths: torch.Tensor, mask_ratio: float,
             keep_bucket: int, generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None) -> MaeMask:
    """Per-example shuffle and mask over static shapes.

    valid: (B, L) patch validity; lengths: (B,) true lengths; ``keep_bucket``
    is the static K dimension (>= the largest keep length in the batch).
    Padding positions get +inf noise, so each example's argsort orders its
    real patches (randomly) first; the first ``keep_len[i]`` shuffled slots
    are the kept patches. The noise is ``torch.rand`` from ``generator``
    (drawn on the generator's device) unless ``noise`` (B, L) is given.

    Both argsorts are stable, as ``jnp.argsort`` is: the padding slots all
    carry +inf, and ``ids_keep`` reaches into them when an image has fewer
    valid patches than ``keep_bucket``, so their order is part of the result.
    The keep length comes from a float64 table built on the host: an fp32
    floor on the device rounds up across an integer boundary for ratios that
    fp32 does not hold exactly (L = 1000, r = 0.9 keeps 99, not 100).
    """
    b, l = valid.shape
    dev = valid.device
    if noise is None:
        if generator is None:
            raise ValueError("mae_mask needs a generator or the noise")
        noise = torch.rand((b, l), generator=generator,
                           device=generator.device)
    noise = torch.as_tensor(noise).to(device=dev, dtype=torch.float32)
    noise = torch.where(valid, noise, torch.full_like(noise, float("inf")))
    ids_shuffle = torch.argsort(noise, dim=-1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=-1, stable=True)

    keep_table = torch.from_numpy(
        mae_keep_len(np.arange(l + 1), mask_ratio)).to(dev)
    keep_lengths = keep_table[lengths.long()]
    ids_keep = ids_shuffle[:, :keep_bucket]
    kept_valid = torch.arange(keep_bucket, device=dev)[None] \
        < keep_lengths[:, None]
    # slot j of the shuffled order is kept iff j < keep_len; in the original
    # order a patch is masked when it is valid and not kept
    shuffled_masked = torch.arange(l, device=dev)[None] \
        >= keep_lengths[:, None]
    seq_mask = torch.gather(shuffled_masked, 1, ids_restore) & valid
    return MaeMask(ids_keep, kept_valid, ids_restore, seq_mask, keep_lengths)


def gather_kept(x: torch.Tensor, mask: MaeMask) -> torch.Tensor:
    """Select kept patches: (B, L, D) -> (B, K, D), padded slots zeroed.
    A row's kept indices are distinct (a prefix of a permutation), so the
    gradient's scatter-add meets no repeated row."""
    idx = mask.ids_keep[..., None].expand(-1, -1, x.shape[-1])
    out = torch.gather(x, 1, idx)
    return torch.where(mask.kept_valid[..., None], out, torch.zeros_like(out))
