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

    def transcribe(self, img, max_len: int = 1536) -> Transcription:
        """One system image (path / PIL / array) -> Transcription."""
        return self.transcribe_batch([img], max_len)[0]

    def transcribe_batch(self, imgs, max_len: int = 1536) -> list:
        """Ragged list of system images -> list of Transcription (greedy)."""
        from .inference.batch_inference import batch_inference
        from .lmx.delinearizer import DelinearizationError, delinearize

        arrays = [self._load_image(i) for i in imgs]
        res = batch_inference(self.params, self.cfg, arrays, self.tokenizer,
                              max_inference_len=max_len,
                              compute_dtype=self.compute_dtype,
                              cache_dtype=self.compute_dtype,
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
