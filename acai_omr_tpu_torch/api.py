"""High-level one-call API: image -> LMX / MusicXML, on the GPU.

    from acai_omr_tpu_torch.api import OmrModel
    model = OmrModel.load("vitomr.npz")          # or no path: seeded weights
    result = model.transcribe("score.png")
    result.lmx          # LMX token string
    result.musicxml     # MusicXML document (None if delinearization failed)
    result.confidence   # exp(mean token log prob)

Runs on ``cuda`` unless ``device="cpu"`` is passed to :meth:`OmrModel.load`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Transcription:
    lmx: str
    musicxml: str | None
    confidence: float
    problems: list


class OmrModel:
    def __init__(self, cfg, params, tokenizer, transform, device,
                 compute_dtype=torch.bfloat16):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.transform = transform
        self.device = device
        self.compute_dtype = compute_dtype
        self.last_result = None  # BatchResult of the last transcribe_batch

    @classmethod
    def load(cls, weights_path: str | None = None, compute_dtype=None,
             device=None, seed: int = 0) -> "OmrModel":
        from . import resolve_device
        from .inference.vitomr_inference import set_up_omr_inference
        device = resolve_device(device)
        compute_dtype = compute_dtype or torch.bfloat16
        cfg, params, tokenizer, transform = set_up_omr_inference(
            weights_path, compute_dtype, device, seed)
        return cls(cfg, params, tokenizer, transform, device, compute_dtype)

    def _load_image(self, img):
        from PIL import Image
        if isinstance(img, (str, bytes)) or hasattr(img, "read"):
            img = Image.open(img).convert("L")
        if isinstance(img, Image.Image):
            return self.transform(img)
        return self.transform(np.asarray(img))

    def transcribe(self, img, max_len: int = 1536, beam_size: int = 1,
                   quantized_kv: bool = False) -> Transcription:
        """One system image (path / PIL / array) -> Transcription."""
        return self.transcribe_batch([img], max_len, beam_size,
                                     quantized_kv)[0]

    def transcribe_batch(self, imgs, max_len: int = 1536, beam_size: int = 1,
                         quantized_kv: bool = False) -> list:
        """Ragged list of system images -> list of Transcription.

        ``beam_size > 1`` uses beam-search decode. ``quantized_kv`` decodes
        with int8 KV caches **and**, by default, int8 weights with per-row
        quantized activations (W8A8; the weight switches of
        ``ops.decode_kernel.weight_quant_mode`` choose int4 or compute-dtype
        weights instead), following the JAX monolith kernel's numerics:
        tokens are near but not bit-identical to compute-dtype decode. The
        two compose.
        """
        from .inference.batch_inference import batch_inference
        from .lmx.delinearizer import DelinearizationError, delinearize

        arrays = [self._load_image(i) for i in imgs]
        res = batch_inference(self.params, self.cfg, arrays, self.tokenizer,
                              max_inference_len=max_len, beam_size=beam_size,
                              compute_dtype=self.compute_dtype,
                              cache_dtype=(torch.int8 if quantized_kv
                                           else self.compute_dtype),
                              device=self.device)
        self.last_result = res
        out = []
        for lmx, avg_lp in zip(res.lmx, res.avg_log_probs):
            try:
                xml, problems = delinearize(lmx)
            except DelinearizationError as e:
                xml, problems = None, [str(e)]
            out.append(Transcription(lmx, xml, float(math.exp(avg_lp)),
                                     problems))
        return out
