"""acai_omr_tpu_torch: the PyTorch + CUDA port of Acai OMR for NVIDIA Hopper.

A second implementation of ``acai_omr_tpu`` in PyTorch, with hand-written
CUDA kernels (``csrc/``) where the JAX package runs Pallas kernels on the
TPU: the inference path (photo of a piano system -> LMX tokens -> MusicXML)
and stage-2 seq2seq training (``train/omr_teacher_force_train.py``, whose
stacks run hand-written kernels forward and backward).
The package imports ``torch`` and never ``jax``; it keeps its own copies of
the host-side modules it needs (tokenizer, transforms, datasets, bucketing,
LMX grammar and delinearizer, PE index tables, patchify).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise (:func:`resolve_device`).
"""

from __future__ import annotations

from enum import Enum

import torch


class InferenceEvent(Enum):
    """Streaming inference events; the serving layer writes these to JSON."""
    ENCODING_START = "encoding_start"
    ENCODING_FINISH = "encoding_finish"
    STEP = "step"
    INFERENCE_FINISH = "inference_finish"
    ALL_INFERENCE_FINISH = "all_inference_finish"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises when no GPU is present and the caller did not ask for the CPU
    explicitly, so a missing card never turns into a silent CPU run.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "acai_omr_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
