"""ViTOMR: ViT encoder -> transition head -> LMX decoder.

The twin of the JAX package's ``models/vitomr.py``: one parameter dict with
the JAX tree's names and layouts, the pure forward functions of inference
and of stage-2 training (teacher-forced and scheduled-sampling forwards, the
padded cross entropy), the generation entry points (the uncached next-token
distribution, the cached greedy and beam decodes) and the sampled rollouts
of stage 3. Randomness is explicit: every training forward takes an integer
``seed`` from which the dropout masks (:mod:`..ops.dropout_kernel`) and the
scheduled-sampling draws are derived on the host; rollouts take a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..ops import dropout_kernel as dk
from ..ops import nn, transformer
from . import decode as decode_lib
from . import omr_decoder, vit_encoder
from .omr_decoder import DecoderConfig
from .vit_encoder import EncoderConfig
from .weights import _flatten, _unflatten, leaf_tensor

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


def vitomr_params_from_mae(vitomr_params: Params, mae_params: Params) -> Params:
    """Transplant a pretrained MAE encoder into a ViTOMR param tree: the
    encoder subtree is taken over leaf for leaf (the frozen / fine-tune split
    needs no renaming, since the layers are one stacked array sliced at run
    time). MAE leaves given as numpy arrays become tensors on the device and
    in the dtype of the leaf they replace."""
    like = _flatten(vitomr_params["encoder"])
    new = _flatten(mae_params["encoder"])
    if like.keys() != new.keys():
        raise KeyError(
            f"encoder tree mismatch: missing {sorted(like.keys() - new.keys())}"
            f", extra {sorted(new.keys() - like.keys())}")
    out = dict(vitomr_params)
    out["encoder"] = _unflatten({
        k: leaf_tensor(v).to(device=like[k].device, dtype=like[k].dtype)
        for k, v in new.items()})
    return out


def transition_head(params: Params, x: torch.Tensor,
                    dropout_rate: float = 0.0, seeds=None,
                    deterministic: bool = True) -> torch.Tensor:
    """Linear(768->4096) -> GELU -> Dropout -> Linear(4096->1024) on
    (B, L, E). The dropout is K10's mask (its own stream, keyed on the image
    and the element), forward and backward."""
    h = nn.gelu(nn.dense(params["linear1"], x))
    if not deterministic and dropout_rate > 0.0:
        h = dk.dropout(h, dk.DropSpec(float(dropout_rate), seeds[0], seeds[1],
                                      dk.STREAM_TRANSITION_HEAD, x.shape[1]))
    return nn.dense(params["linear2"], h)


def encode_image(params: Params, cfg: ViTOMRConfig, patches, pe_idx, pe_w,
                 valid, *, compute_dtype=torch.float32, seed: int | None = None,
                 deterministic: bool = True,
                 frozen_stop_gradient: bool = False):
    """Encoder + transition head -> (img_latent (B, L, E_dec), latent_valid)."""
    enc_seeds = head_seeds = None
    if seed is not None:
        enc_seeds, head_seeds = dk.fold_seed(seed, 0), dk.fold_seed(seed, 1)
    latent, latent_valid = vit_encoder.encode(
        params["encoder"], cfg.encoder, patches, pe_idx, pe_w, valid,
        compute_dtype=compute_dtype, seeds=enc_seeds,
        deterministic=deterministic,
        frozen_stop_gradient=frozen_stop_gradient)
    latent = transition_head(params["transition_head"], latent,
                             cfg.transition_head_dropout, head_seeds,
                             deterministic)
    return latent, latent_valid


def forward_teacher_forced(params: Params, cfg: ViTOMRConfig, patches, pe_idx,
                           pe_w, valid, input_seqs, lmx_valid, *,
                           compute_dtype=torch.float32,
                           seed: int | None = None, deterministic: bool = True,
                           frozen_stop_gradient: bool = False) -> torch.Tensor:
    """Image batch + right-shifted LMX -> (B, T, V) fp32 logits."""
    img_latent, latent_valid = encode_image(
        params, cfg, patches, pe_idx, pe_w, valid, compute_dtype=compute_dtype,
        seed=None if seed is None else dk.fold_seed(seed, 10)[0],
        deterministic=deterministic,
        frozen_stop_gradient=frozen_stop_gradient)
    mem_kv = transformer.precompute_memory_kv(
        params["decoder"]["blocks"], img_latent.to(compute_dtype))
    return omr_decoder.forward(
        params["decoder"], cfg.decoder, input_seqs, img_latent, lmx_valid,
        latent_valid, compute_dtype=compute_dtype,
        seeds=None if seed is None else dk.fold_seed(seed, 11),
        deterministic=deterministic, mem_kv=mem_kv)


# ---------------------------------------------------------------------------
# scheduled sampling
# ---------------------------------------------------------------------------

def gumbel_softmax(logits: torch.Tensor, tau: float, hard: bool,
                   noise: torch.Tensor) -> torch.Tensor:
    """F.gumbel_softmax with the Gumbel ``noise`` passed in (straight-through
    when ``hard``, in torch's order ``y_hard - y.detach() + y``)."""
    y = torch.softmax((logits.float() + noise) / tau, dim=-1)
    if hard:
        y_hard = torch.nn.functional.one_hot(
            y.argmax(dim=-1), logits.shape[-1]).to(y.dtype)
        y = y_hard - y.detach() + y
    return y


def sample_and_mix_seqs(params: Params, tf_input_seqs: torch.Tensor,
                        tf_pred_logits: torch.Tensor,
                        teacher_forcing_prob: float, sample_tau: float,
                        use_hard_sampling: bool, compute_dtype=torch.float32,
                        *, generator: torch.Generator | None = None,
                        sample_mask: torch.Tensor | None = None,
                        noise: torch.Tensor | None = None) -> torch.Tensor:
    """Mix gold embeddings with gumbel-softmax expected embeddings of the
    first pass' predictions -> (B, T, E).

    The position mask (True = take the sampled embedding) and the Gumbel noise
    are drawn from ``generator`` (on the logits' device) unless the caller
    passes them in, which is how two implementations are held to one draw.
    """
    dev = tf_pred_logits.device
    if sample_mask is None:
        sample_mask = torch.rand(tf_input_seqs.shape, generator=generator,
                                 device=dev) < (1.0 - teacher_forcing_prob)
    if noise is None:
        noise = nn.gumbel_noise(tf_pred_logits.shape, generator, dev)
    table = params["decoder"]["vocab_embedding"]["table"].to(compute_dtype)
    gold = nn.embed(params["decoder"]["vocab_embedding"], tf_input_seqs,
                    compute_dtype)
    distr = gumbel_softmax(tf_pred_logits, sample_tau, use_hard_sampling,
                           noise)
    expected = torch.matmul(distr.to(compute_dtype), table)
    # right-shift the predictions to align with the right-shifted inputs:
    # prepend the <bos> embedding stem, drop the last step
    expected = torch.cat([gold[:, :1, :], expected[:, :-1, :]], dim=1)
    return torch.where(sample_mask[..., None], expected, gold)


def forward_scheduled_sampling(params: Params, cfg: ViTOMRConfig, patches,
                               pe_idx, pe_w, valid, input_seqs, lmx_valid,
                               teacher_forcing_prob: float, sample_tau: float,
                               use_hard_sampling: bool, seed: int, *,
                               compute_dtype=torch.float32,
                               deterministic: bool = False,
                               frozen_stop_gradient: bool = True
                               ) -> torch.Tensor:
    """Two-pass scheduled-sampling forward: teacher-forced logits ->
    gumbel-mixed embeddings -> second decoder pass. Both passes share one
    ``mem_kv`` and draw different dropout seeds; the first pass's logits carry
    gradient through the mix."""
    img_latent, latent_valid = encode_image(
        params, cfg, patches, pe_idx, pe_w, valid, compute_dtype=compute_dtype,
        seed=dk.fold_seed(seed, 20)[0], deterministic=deterministic,
        frozen_stop_gradient=frozen_stop_gradient)
    mem_kv = transformer.precompute_memory_kv(
        params["decoder"]["blocks"], img_latent.to(compute_dtype))
    tf_logits = omr_decoder.forward(
        params["decoder"], cfg.decoder, input_seqs, img_latent, lmx_valid,
        latent_valid, compute_dtype=compute_dtype,
        seeds=dk.fold_seed(seed, 21), deterministic=deterministic,
        mem_kv=mem_kv)
    gen = torch.Generator(device=tf_logits.device)
    gen.manual_seed(dk.fold_seed(seed, 22)[0])
    mixed = sample_and_mix_seqs(params, input_seqs, tf_logits,
                                teacher_forcing_prob, sample_tau,
                                use_hard_sampling, compute_dtype,
                                generator=gen)
    return omr_decoder.forward(
        params["decoder"], cfg.decoder, mixed, img_latent, lmx_valid,
        latent_valid, token_idxs_input=False, compute_dtype=compute_dtype,
        seeds=dk.fold_seed(seed, 23), deterministic=deterministic,
        mem_kv=mem_kv)


def omr_ce_loss(logits: torch.Tensor, target_seqs: torch.Tensor, pad_idx: int,
                label_smoothing: float = 0.0, reduction: str = "mean"):
    """Cross entropy that ignores ``pad_idx`` targets. ``reduction="sum"``
    returns ``(nll_sum, token_count)``; ``"mean"`` their ratio (an all-padding
    batch gives 0, not NaN)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, target_seqs.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll \
            + label_smoothing * -logp.mean(dim=-1)
    mask = (target_seqs != pad_idx).float()
    if reduction == "sum":
        return (nll * mask).sum(), mask.sum()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# generation entry points
# ---------------------------------------------------------------------------

# the query and key rows of the card's attention tiles: K3 takes whole tiles
ATTN_TILE = 64


def _tile_rows(n: int) -> int:
    return -(-n // ATTN_TILE) * ATTN_TILE


def generate_next_token_distr(params: Params, cfg: ViTOMRConfig,
                              img_latent: torch.Tensor, seqs: torch.Tensor,
                              compute_dtype=torch.float32,
                              latent_valid: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Beam-search-ready next-token distribution, uncached (reference:
    TeacherForcedViTOMR.generate, models.py:749-757): one image's latent
    (1, M, E) held by every row of ``seqs`` (N, T), and the (N, V) fp32 log
    probabilities of the next token of each row.

    ``latent_valid`` (1, M): REQUIRED when the latent comes from a padded
    batchify (the bucket's pad rows carry nonzero values after the encoder;
    without the mask every row cross-attends them and the distribution is
    contaminated). The reference worked on unpadded per-image latents and
    had no such argument.

    The decoder's attention kernels take whole tiles of :data:`ATTN_TILE`
    rows, so the prefixes are padded with ``<pad>`` past their end (masked,
    and after every real position under the causal mask) and the latent
    with masked rows, to whole tiles; the last real position's logits are
    read. Neither padding reaches a real position's result."""
    n, t = seqs.shape
    m = img_latent.shape[1]
    t_pad = max(t, min(_tile_rows(t), cfg.decoder.max_lmx_seq_len))
    m_pad = _tile_rows(m)
    dev = seqs.device
    seqs = torch.nn.functional.pad(seqs, (0, t_pad - t),
                                   value=cfg.decoder.pad_idx)
    lmx_valid = (torch.arange(t_pad, device=dev) < t)[None].expand(n, t_pad)
    if latent_valid is None:
        latent_valid = torch.ones((1, m), dtype=torch.bool, device=dev)
    latent_valid = torch.nn.functional.pad(latent_valid, (0, m_pad - m))
    latent = torch.nn.functional.pad(img_latent, (0, 0, 0, m_pad - m))
    logits = omr_decoder.forward(
        params["decoder"], cfg.decoder, seqs,
        latent.expand(n, m_pad, latent.shape[2]).contiguous(), lmx_valid,
        latent_valid.expand(n, m_pad), compute_dtype=compute_dtype)
    return torch.log_softmax(logits[:, t - 1, :], dim=-1)


def cached_greedy_generate(params: Params, cfg: ViTOMRConfig, img_latent,
                           latent_valid=None, max_len: int = 1536, **kwargs):
    """(seqs, log_probs, seq_mask) of the KV-cached greedy decode
    (reference models.py:600-615); ``kwargs`` go to
    :func:`.decode.generate`."""
    return decode_lib.generate(params["decoder"], cfg.decoder, img_latent,
                               latent_valid, max_len=max_len, **kwargs)


def cached_beam_generate(params: Params, cfg: ViTOMRConfig, img_latent,
                         latent_valid=None, beam_size: int = 4,
                         max_len: int = 1536, **kwargs):
    """(seqs, log_probs, seq_mask) of the best length-normalised beam of a
    KV-cached beam search (the reference decodes greedily, with a
    beam-ready uncached ``generate``); ``kwargs`` go to
    :func:`.decode.beam_generate`."""
    return decode_lib.beam_generate(params["decoder"], cfg.decoder,
                                    img_latent, latent_valid,
                                    beam_size=beam_size, max_len=max_len,
                                    **kwargs)


def expand_img_latent_for_rollout(img_latent, latent_valid, group_size: int):
    """(B, M, E) -> (B*G, M, E), and the mask alike: each image's rows
    repeated ``group_size`` times in place (models.py:883-891)."""
    return (img_latent.repeat_interleave(group_size, dim=0),
            latent_valid.repeat_interleave(group_size, dim=0))


# ---------------------------------------------------------------------------
# rollouts (stage 3)
# ---------------------------------------------------------------------------

def forward_rollout_policy(params: Params, cfg: ViTOMRConfig, img_latent,
                           latent_valid, generator: torch.Generator | None,
                           max_actions: int = 768, top_k: int = 50,
                           temperature: float = 1.1, group_size: int = 1,
                           mesh=None, **kwargs):
    """Sampled KV-cached rollouts -> (seqs, log_probs, mask).

    ``group_size=G > 1`` decodes G rollouts per image from the unexpanded
    latent (decode ``mem_group``): the order of the G-times-repeated latent,
    with the cross K/V projected and held once per image. The Gumbel noise
    comes from ``generator``. ``kwargs`` go to :func:`.decode.generate`.
    ``mesh``: the images cut over the mesh's data axis, one decode loop per
    data shard in lock step (:func:`.decode.sharded_generate`); shard d
    draws its noise from a seed drawn from ``generator``, plus d."""
    sampling = decode_lib.SamplingConfig(top_k=top_k, temperature=temperature)
    if mesh is not None:
        seed = 0 if generator is None else int(torch.randint(
            2 ** 31 - 1, (), generator=generator, device=generator.device))
        return decode_lib.sharded_generate(
            params["decoder"], cfg.decoder, img_latent, latent_valid, mesh,
            max_len=max_actions, sampling=sampling, seed=seed,
            mem_group=group_size, **kwargs)
    return decode_lib.generate(params["decoder"], cfg.decoder, img_latent,
                               latent_valid, max_len=max_actions,
                               sampling=sampling, generator=generator,
                               mem_group=group_size, **kwargs)


def batch_policy_inference(params: Params, cfg: ViTOMRConfig, imgs,
                           generator: torch.Generator | None = None,
                           max_actions: int = 768, top_k: int = 50,
                           temperature: float = 1.1,
                           compute_dtype=torch.bfloat16, device=None,
                           **kwargs):
    """Encode a ragged list of (C, H, W) images and run one sampled rollout
    for each, caches in the compute dtype unless ``cache_dtype`` says
    otherwise. Runs on ``cuda`` unless ``device`` says otherwise; ``params``
    must live there."""
    device = resolve_device(device)
    kwargs.setdefault("cache_dtype", compute_dtype)
    pb = vit_encoder.batchify(imgs, cfg.encoder)
    with torch.no_grad():
        latent, latent_valid = encode_image(params, cfg, *pb.to(device),
                                            compute_dtype=compute_dtype)
    return forward_rollout_policy(params, cfg, latent, latent_valid,
                                  generator, max_actions, top_k, temperature,
                                  compute_dtype=compute_dtype, **kwargs)
