"""Batched inference over ragged multi-resolution images.

The twin of the JAX package's ``inference/batch_inference.py``: images are
grouped into encoder shape buckets, each group is encoded and decoded with
the KV-cached loop (greedy or beam search, compute-dtype or int8 caches, on
one device or over a data- and tensor-parallel mesh), and results come back
in input order. Ragged tail groups are padded up to a power
of two (capped at ``decode_batch``) by repeating their first image, so a
request mix meets only a few batch shapes.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..models import decode as decode_lib
from ..models import vit_encoder, vitomr as vitomr_lib
from ..models.vitomr import ViTOMRConfig


@dataclasses.dataclass
class BatchResult:
    lmx: list            # LMX string per image (input order)
    avg_log_probs: list  # mean per-token log prob per image
    seqs: list           # raw id arrays (trimmed, specials included)
    encode_seconds: float = 0.0  # wall time of the encodes (device-synced)
    decode_seconds: float = 0.0  # wall time of the decodes (device-synced)
    n_tokens: int = 0            # tokens generated for the real images (through <eos>)


def _bucket_key(img, cfg, bucket_multiple):
    p = cfg.encoder.patch_size
    hp, wp = img.shape[-2] // p, img.shape[-1] // p
    return vit_encoder.bucket_len(hp * wp, bucket_multiple)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_inference(params, cfg: ViTOMRConfig, imgs, tokenizer, *,
                    max_inference_len: int = 1536, decode_batch: int = 32,
                    bucket_multiple: int = 128, beam_size: int = 1,
                    length_penalty: float = 0.6,
                    compute_dtype=torch.bfloat16,
                    cache_dtype=torch.bfloat16, device=None,
                    mesh=None, model_axis: str | None = None,
                    progress_cb=None,
                    progress_interval: int = 25) -> BatchResult:
    """Transcribe a list of (C, H, W) float arrays of arbitrary sizes.

    ``params`` must live on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``). ``beam_size > 1`` switches the decode to beam search
    (the effective decode batch is ``decode_batch * beam_size`` rows over
    ``decode_batch`` memories). ``cache_dtype=torch.int8`` is the quantized
    decode: int8 KV caches **and**, by default, int8 weights with per-row
    quantized activations (W8A8; int4 weights under ``ACAI_W4A8_DECODE=1``,
    compute-dtype weights under ``ACAI_W8A8_DECODE=0``), with the JAX
    monolith kernel's numerics; tokens are near but not bit-identical to
    compute-dtype decode. It composes with beams.

    ``mesh`` (:class:`..parallel.mesh.Mesh`): decode each bucket group over
    the mesh (:func:`..models.decode.sharded_generate` /
    :func:`..models.decode.sharded_beam_generate`). The group is padded up
    to the data axis by repeating its first row (the pad rows are dropped),
    and ``model_axis`` adds tensor parallelism (heads and MLP split, the
    decoder's shards prepared once per call). The encode runs on ``device``,
    which defaults to the mesh's first device.

    ``progress_cb(img_indices, seqs, t, finished)``: mid-decode streaming
    hook of the greedy paths (plain and meshed), called every
    ``progress_interval`` decode steps per bucket group with the ORIGINAL
    image indices of the group's rows, the raw (rows, max_len) sequence
    buffer so far, the decode position and a per-row finished mask;
    batch-pad rows never surface. Beam decodes do not surface mid-decode
    state.
    """
    if device is None and mesh is not None:
        device = mesh.devices[0][0]
    device = resolve_device(device)
    tp_params = None
    if mesh is not None and model_axis is not None \
            and mesh.shape[model_axis] > 1:
        # shuffle and split the decoder once for every bucket group
        tp_params = decode_lib.prepare_tp_decode_params(
            params["decoder"], cfg.decoder, mesh, model_axis)
    order = sorted(range(len(imgs)),
                   key=lambda i: _bucket_key(imgs[i], cfg, bucket_multiple))
    lmx_out = [None] * len(imgs)
    lp_out = [0.0] * len(imgs)
    seq_out = [None] * len(imgs)
    enc_s = dec_s = 0.0
    n_tokens = 0

    i = 0
    while i < len(order):
        # same-bucket run, capped at decode_batch
        key = _bucket_key(imgs[order[i]], cfg, bucket_multiple)
        group = [order[i]]
        while (len(group) < decode_batch and i + len(group) < len(order)
               and _bucket_key(imgs[order[i + len(group)]], cfg,
                               bucket_multiple) == key):
            group.append(order[i + len(group)])
        i += len(group)

        group_cb = None
        seg_steps = None
        if progress_cb is not None and beam_size == 1:
            # the slice to len(gi) drops batch-pad rows
            group_cb = (lambda s, t, fin, gi=list(group):
                        progress_cb(gi, s[: len(gi)], t, fin[: len(gi)]))
            seg_steps = progress_interval

        n_real = len(group)
        b_pad = 1
        while b_pad < n_real:
            b_pad *= 2
        b_pad = min(b_pad, decode_batch)
        group_imgs = [imgs[g] for g in group] \
            + [imgs[group[0]]] * (b_pad - n_real)
        pb = vit_encoder.batchify(group_imgs, cfg.encoder, bucket_multiple)

        _sync(device)
        t0 = time.perf_counter()
        latent, latent_valid = vitomr_lib.encode_image(
            params, cfg, *pb.to(device), compute_dtype=compute_dtype)
        _sync(device)
        t1 = time.perf_counter()
        if mesh is not None:
            from ..parallel.mesh import DATA_AXIS
            pad = (-latent.shape[0]) % mesh.shape[DATA_AXIS]
            if pad:  # repeat rows so the batch shards evenly; dropped below
                latent = torch.cat([latent, latent[:1].expand(
                    pad, *latent.shape[1:])])
                latent_valid = torch.cat([latent_valid, latent_valid[:1]
                                          .expand(pad, -1)])
            mesh_kw = dict(axis=DATA_AXIS, model_axis=model_axis,
                           max_len=max_inference_len,
                           compute_dtype=compute_dtype,
                           cache_dtype=cache_dtype, tp_params=tp_params)
        if beam_size > 1 and mesh is not None:
            seqs, lps, mask = decode_lib.sharded_beam_generate(
                params["decoder"], cfg.decoder, latent, latent_valid, mesh,
                beam_size=beam_size, length_penalty=length_penalty,
                **mesh_kw)
        elif beam_size > 1:
            seqs, lps, mask = decode_lib.beam_generate(
                params["decoder"], cfg.decoder, latent, latent_valid,
                beam_size=beam_size, length_penalty=length_penalty,
                max_len=max_inference_len, compute_dtype=compute_dtype,
                cache_dtype=cache_dtype)
        elif mesh is not None:
            seqs, lps, mask = decode_lib.sharded_generate(
                params["decoder"], cfg.decoder, latent, latent_valid, mesh,
                progress_cb=group_cb, segment_steps=seg_steps, **mesh_kw)
        else:
            seqs, lps, mask = decode_lib.generate(
                params["decoder"], cfg.decoder, latent, latent_valid,
                max_len=max_inference_len, compute_dtype=compute_dtype,
                cache_dtype=cache_dtype, progress_cb=group_cb,
                segment_steps=seg_steps)
        seqs, lps, mask = (a.cpu().numpy() for a in (seqs, lps, mask))
        t2 = time.perf_counter()
        enc_s += t1 - t0
        dec_s += t2 - t1
        for row, g in enumerate(group):
            ids = seqs[row][mask[row]]
            lmx_out[g] = tokenizer.decode(ids)
            n = max(int(mask[row].sum()), 1)
            lp_out[g] = float(lps[row][mask[row]].sum() / n)
            seq_out[g] = ids
            n_tokens += int(mask[row].sum()) - 1  # <bos> is not generated

    return BatchResult(lmx_out, lp_out, seq_out, enc_s, dec_s, n_tokens)
