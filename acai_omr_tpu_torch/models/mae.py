"""Masked Autoencoder pretraining model (stage 1 of 3).

The twin of the JAX package's ``models/mae.py``: mask -> encode the visible
patches -> unshuffle with mask tokens -> decode -> per-patch-normalised pixel
loss, over static-shape packed batches. Both transformer stacks go through
:func:`..ops.transformer.encoder_stack`: on CUDA tensors that is the fused
kernel path, forward and hand-written backward, for the ViT-B encoder over
the kept rows (head dim 64) and for the 16-head, 512-wide decoder over all
rows (head dim 32). What the JAX package computes outside its Pallas kernels
stays PyTorch ops under autograd here: the patch projection and PE gathers,
the two argsorts of the mask, the gather of kept rows, the final norms, the
768 -> 512 embed, the unshuffle, the 512 -> 256 unembed and the loss.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device
from ..ops import nn, transformer
from ..ops import pe as pe_ops
from . import vit_encoder
from .vit_encoder import EncoderConfig

Params = dict


@dataclasses.dataclass(frozen=True)
class MaeConfig:
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    mask_ratio: float = 0.75
    decoder_num_layers: int = 8
    decoder_hidden_dim: int = 512
    decoder_num_heads: int = 16
    decoder_mlp_dim: int = 3072

    @property
    def patch_size(self) -> int:
        return self.encoder.patch_size


def init_mae_params(cfg: MaeConfig, seed: int = 0, dtype=torch.float32,
                    device=None) -> Params:
    """Random parameters at ``cfg``'s shapes, drawn from ``seed`` with an
    explicit ``torch.Generator`` (same distributions as the JAX init). Runs
    on ``cuda`` unless ``device`` says otherwise."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    enc, e_dec = cfg.encoder, cfg.decoder_hidden_dim
    return {
        "encoder": vit_encoder.init_encoder_params(gen, enc, dtype, device),
        "decoder_embed": nn.dense_init(gen, enc.hidden_dim, e_dec, dtype,
                                       device),
        "decoder_blocks": transformer.stack_init(
            transformer.encoder_layer_init, gen, cfg.decoder_num_layers,
            e_dec, cfg.decoder_mlp_dim, dtype, device),
        "decoder_norm": nn.layernorm_init(e_dec, dtype, device),
        "decoder_unembed": nn.dense_init(gen, e_dec, enc.patch_dim, dtype,
                                         device),
        "mask_token": nn.trunc_normal(gen, (e_dec,), std=0.1, dtype=dtype,
                                      device=device),
        "decoder_pos_embedding": nn.trunc_normal(
            gen, (enc.pe_max_height, enc.pe_max_width, e_dec), std=0.1,
            dtype=dtype, device=device),
    }


def keep_bucket_len(seq_bucket: int, mask_ratio: float,
                    multiple: int = 128) -> int:
    """Static K dimension for the kept-patch sequence of a given L bucket."""
    k = math.ceil(seq_bucket * (1.0 - mask_ratio))
    return max(multiple, -(-k // multiple) * multiple)


def forward(params: Params, cfg: MaeConfig, patches, pe_idx, pe_w, valid,
            lengths, target_patches, *, generator=None, mask_noise=None,
            compute_dtype=torch.float32):
    """Full MAE forward on a packed batch.

    patches / pe_idx / pe_w / valid / lengths come from
    :func:`.vit_encoder.batchify`; ``target_patches`` is the independently
    patchified (possibly un-augmented) target batch. The mask's noise is drawn
    from ``generator`` unless ``mask_noise`` (B, L) is given. There is no
    dropout on this path (the encoder's rate is 0 in pretraining and the
    decoder has none).

    Returns (pred (B, L, P*P) fp32, loss_mask (B, L) bool, target_patches),
    ready for :func:`mae_loss`.
    """
    enc_cfg = cfg.encoder
    b, l = valid.shape
    kb = min(l, keep_bucket_len(l, cfg.mask_ratio))

    # mask + encode the visible patches
    mask = vit_encoder.mae_mask(valid, lengths, cfg.mask_ratio, kb,
                                generator=generator, noise=mask_noise)
    x = vit_encoder.embed_patches(params["encoder"], patches, pe_idx, pe_w,
                                  valid, compute_dtype)
    x_kept = vit_encoder.gather_kept(x, mask)                      # (B, K, E)
    latent = transformer.encoder_stack(params["encoder"]["blocks"], x_kept,
                                       mask.kept_valid, enc_cfg.num_heads)
    latent = nn.layernorm(params["encoder"]["final_norm"], latent, eps=1e-6)

    # project to the decoder's width, unshuffle with mask tokens: slot
    # j < keep_len of the shuffled order is encoded latent j, every other
    # slot the mask token. Slots past an image's length are junk; attention
    # masks them as keys and the loss leaves them out.
    latent = nn.dense(params["decoder_embed"], latent)            # (B, K, Ed)
    latent_padded = torch.nn.functional.pad(latent, (0, 0, 0, l - kb))
    shuf_col = torch.arange(l, device=valid.device)[None, :, None]
    mask_tok = params["mask_token"].to(latent.dtype)
    full_shuffled = torch.where(shuf_col < mask.keep_lengths[:, None, None],
                                latent_padded, mask_tok[None, None, :])
    # ids_restore is a permutation of each row: a gather without repeats
    x_full = torch.gather(
        full_shuffled, 1,
        mask.ids_restore[..., None].expand(-1, -1, full_shuffled.shape[-1]))

    # decoder PE: the encoder's grid addressing on the decoder-width grid
    x_full = x_full + pe_ops.gather_pe(
        params["decoder_pos_embedding"].to(x_full.dtype), pe_idx, pe_w)

    # decode over the full (unshuffled) sequence
    hidden = transformer.encoder_stack(params["decoder_blocks"], x_full,
                                       valid, cfg.decoder_num_heads)
    hidden = nn.layernorm(params["decoder_norm"], hidden, eps=1e-6)
    pred = nn.dense(params["decoder_unembed"], hidden)          # (B, L, P*P)
    return pred.float(), mask.seq_mask, target_patches


def mae_loss(pred: torch.Tensor, loss_mask: torch.Tensor,
             target: torch.Tensor, reduction: str = "mean"):
    """Per-patch-normalised masked pixel MSE: each target patch is centred
    and divided by ``sqrt(var + 1e-6)`` with the unbiased variance (n - 1).

    ``"mean"`` divides by ``max(count, 1)``, so a batch with no masked patch
    gives 0, not NaN; ``"sum"`` returns ``(loss_sum, patch_count)``.
    """
    target = target.float()
    mean = target.mean(dim=-1, keepdim=True)
    n = target.shape[-1]
    var = (target - mean).square().sum(dim=-1, keepdim=True) / (n - 1)
    target = (target - mean) / torch.sqrt(var + 1.0e-6)

    loss = (pred - target).square().mean(dim=-1)  # (B, L)
    loss_mask = loss_mask.float()
    total, count = (loss * loss_mask).sum(), loss_mask.sum()
    if reduction == "sum":
        return total, count
    return total / count.clamp_min(1.0)
