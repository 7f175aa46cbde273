"""End-to-end inference: image -> LMX -> MusicXML (-> rendered image).

The twin of the JAX package's ``inference/vitomr_inference.py``: the flagship
configuration with its weights, tokenizer and image transform
(:func:`set_up_omr_inference`; weights come from a numpy ``.npz`` of the JAX
parameter tree, or from a checkpoint directory the JAX package wrote, which
needs the optional ``tensorstore``, or are drawn from a seed), the ``inference`` /
``streamed_inference`` entry points, ``delinearize`` and
``convert_back_to_img`` post-processing, and a command line:

    python -m acai_omr_tpu_torch.inference.vitomr_inference score.png \
        [-w weights.npz] [-b BEAM] [--int8-kv] [--device cpu]
"""

from __future__ import annotations

import logging
import os
import subprocess
from pathlib import Path

import torch

from .. import InferenceEvent, resolve_device
from ..config import (LMX_VOCAB_PATH, MAX_LMX_SEQ_LEN, NUM_DECODER_LAYERS,
                      OMR_MAX_IMG_SEQ_LEN, PATCH_SIZE, PE_MAX_HEIGHT,
                      PE_MAX_WIDTH, ENCODER_FINE_TUNE_DEPTH)
from ..data import transforms as tf_lib
from ..data.tokenizer import LmxTokenizer
from ..lmx import delinearizer as delin_lib
from ..models import decode as decode_lib
from ..models import vit_encoder
from ..models import vitomr as vitomr_lib
from ..models.omr_decoder import DecoderConfig
from ..models.vit_encoder import EncoderConfig
from ..models.vitomr import ViTOMRConfig
from ..models.weights import load_npz

logger = logging.getLogger(__name__)


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
    ``.npz`` of the JAX parameter tree or a JAX checkpoint directory
    (:func:`..models.weights.load_npz`) when given, else are drawn from
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


def encode_images(params, cfg: ViTOMRConfig, imgs,
                  compute_dtype=torch.bfloat16, device=None):
    """List of (C, H, W) arrays -> (img_latent, latent_valid) on ``device``."""
    device = resolve_device(device)
    pb = vit_encoder.batchify(imgs, cfg.encoder)
    return vitomr_lib.encode_image(params, cfg, *pb.to(device),
                                   compute_dtype=compute_dtype)


def inference(params, cfg: ViTOMRConfig, img, max_inference_len: int = 1536,
              compute_dtype=torch.bfloat16, beam_size: int = 1,
              cache_dtype=torch.bfloat16, device=None):
    """Batched decode, greedy by default; ``beam_size > 1`` runs beam search,
    ``cache_dtype=torch.int8`` the quantized decode (int8 caches and, by
    default, W8A8 weights: ``ops.decode_kernel.weight_quant_mode``; composes
    with beams).

    ``img``: one (C, H, W) array or a list of them (ragged sizes fine).
    Returns (seqs, log_probs, seq_mask) as numpy arrays.
    """
    imgs = img if isinstance(img, (list, tuple)) else [img]
    latent, latent_valid = encode_images(params, cfg, imgs, compute_dtype,
                                         device)
    kwargs = dict(max_len=max_inference_len, compute_dtype=compute_dtype,
                  cache_dtype=cache_dtype)
    if beam_size > 1:
        out = decode_lib.beam_generate(params["decoder"], cfg.decoder, latent,
                                       latent_valid, beam_size=beam_size,
                                       **kwargs)
    else:
        out = decode_lib.generate(params["decoder"], cfg.decoder, latent,
                                  latent_valid, **kwargs)
    return tuple(a.cpu().numpy() for a in out)


def streamed_inference(params, cfg: ViTOMRConfig, img,
                       max_inference_len: int = 1536, flush_interval: int = 25,
                       compute_dtype=torch.bfloat16, device=None):
    """Generator of InferenceEvent dicts: ENCODING_START, ENCODING_FINISH,
    STEP (token chunks) ..., INFERENCE_FINISH."""
    yield {"type": InferenceEvent.ENCODING_START.value, "payload": None}
    latent, latent_valid = encode_images(params, cfg, [img], compute_dtype,
                                         device)
    yield {"type": InferenceEvent.ENCODING_FINISH.value, "payload": None}
    for kind, payload in decode_lib.streamed_generate(
            params["decoder"], cfg.decoder, latent, latent_valid,
            max_len=max_inference_len, flush_interval=flush_interval,
            compute_dtype=compute_dtype):
        if kind == "step":
            yield {"type": InferenceEvent.STEP.value,
                   "payload": {"tokens": payload}}
        else:
            seqs, log_probs, mask = (a.cpu().numpy() for a in payload)
            yield {"type": InferenceEvent.INFERENCE_FINISH.value,
                   "payload": {"sequence": seqs, "log_probs": log_probs,
                               "mask": mask}}


def delinearize(lmx_seq: str, lmx_seq_path: str, xml_file_path: str) -> dict:
    """LMX string -> .lmx + .musicxml files, in-process."""
    logger.info("Delinearizing lmx sequence (%d tokens)", len(lmx_seq.split()))
    Path(lmx_seq_path).write_text(lmx_seq)
    try:
        xml, problems = delin_lib.delinearize(lmx_seq)
    except delin_lib.DelinearizationError as e:
        logger.warning("Delinearization catastrophically failed: %s", e)
        return {"ok": False, "error": str(e)}
    Path(xml_file_path).write_text(xml)
    if problems:
        logger.warning("Caught problems with delinearization: %s", problems)
    return {"ok": True, "xml_file_path": xml_file_path,
            "delinearize_problems": problems}


def convert_back_to_img(xml_file_path: str, img_file_path: str) -> str | None:
    """Render MusicXML via musescore3 + imagemagick when installed; returns
    None when the toolchain is absent. The musescore intermediate lives next
    to the caller's output file, so concurrent renders do not collide."""
    inter = str(Path(img_file_path).with_suffix("")) + ".mscore_out.png"
    inter1 = str(Path(img_file_path).with_suffix("")) + ".mscore_out-1.png"
    try:
        subprocess.run(["musescore3", "-o", inter, xml_file_path],
                       check=True, capture_output=True)
        subprocess.run(["convert", inter1, "-background", "white",
                        "-alpha", "remove", "-alpha", "off", img_file_path],
                       check=True, capture_output=True)
        os.remove(inter1)
        return img_file_path
    except (FileNotFoundError, subprocess.CalledProcessError) as e:
        logger.warning("musescore/imagemagick rendering unavailable: %s", e)
        return None


def main(argv=None):
    import argparse
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="Acai OMR inference (PyTorch)")
    ap.add_argument("image", help="path to a system image")
    ap.add_argument("-w", "--weights", default=None)
    ap.add_argument("-o", "--out-prefix", default="inference_result")
    ap.add_argument("-b", "--beam-size", type=int, default=1,
                    help="beam-search width (1 = greedy)")
    ap.add_argument("--int8-kv", action="store_true",
                    help="quantized decode: int8 KV caches and W8A8 weights "
                         "(ACAI_W4A8_DECODE=1: int4, ACAI_W8A8_DECODE=0: "
                         "unquantized)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from PIL import Image
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg, params, tokenizer, transform = set_up_omr_inference(
        args.weights, dtype, device)
    img = transform(Image.open(args.image).convert("L"))
    seqs, log_probs, mask = inference(
        params, cfg, img, compute_dtype=dtype, beam_size=args.beam_size,
        cache_dtype=torch.int8 if args.int8_kv else dtype, device=device)
    for i in range(seqs.shape[0]):
        ids = seqs[i][mask[i]]
        lmx = tokenizer.decode(ids)
        avg_lp = float(log_probs[i][mask[i]].sum() / max(mask[i].sum(), 1))
        logger.info("Decoded: %s\nAverage log prob per token: %f", lmx, avg_lp)
        resp = delinearize(lmx, f"{args.out_prefix}.lmx",
                           f"{args.out_prefix}.musicxml")
        if resp["ok"]:
            convert_back_to_img(resp["xml_file_path"],
                                f"{args.out_prefix}.png")


if __name__ == "__main__":
    main()
