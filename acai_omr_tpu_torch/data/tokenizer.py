"""LMX tokenizer: vocab file I/O, encode/decode helpers.

Parity with the reference's vocab handling inside ``OMRDecoder.__init__``
(reference: acai_omr/models/models.py:392-401), ``PrepareLMXSequence``
(acai_omr/train/omr_teacher_force_train.py:85-94) and ``stringify_lmx_seq``
(acai_omr/utils/utils.py:196-202), pulled out into a standalone component so
data pipeline, models and serving share one implementation.
"""

from __future__ import annotations

import numpy as np

from ..config import LMX_BOS_TOKEN, LMX_EOS_TOKEN, LMX_PAD_TOKEN, LMX_VOCAB_PATH


class LmxTokenizer:
    def __init__(self, vocab_path: str = LMX_VOCAB_PATH):
        with open(vocab_path, "r") as f:
            tokens = [line.strip() for line in f if line.strip()]
        self.vocab_path = vocab_path
        self.tokens = tokens
        self.tokens_to_idxs = {tok: i for i, tok in enumerate(tokens)}
        self.idxs_to_tokens = {i: tok for i, tok in enumerate(tokens)}
        self.pad_idx = self.tokens_to_idxs[LMX_PAD_TOKEN]
        self.bos_idx = self.tokens_to_idxs[LMX_BOS_TOKEN]
        self.eos_idx = self.tokens_to_idxs[LMX_EOS_TOKEN]

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def encode(self, lmx: str) -> np.ndarray:
        """LMX string -> int32 ids with <bos>/<eos> wrapping."""
        toks = [LMX_BOS_TOKEN] + lmx.strip().split() + [LMX_EOS_TOKEN]
        return np.array([self.tokens_to_idxs[t] for t in toks], dtype=np.int32)

    def decode(self, ids) -> str:
        """Id sequence (assumed to start with <bos>) -> LMX string.

        Strips the leading <bos> and one trailing <eos> if present, mirroring
        stringify_lmx_seq (reference: utils.py:196-202).
        """
        toks = [self.idxs_to_tokens[int(i)] for i in ids]
        if toks and toks[-1] == LMX_EOS_TOKEN:
            toks.pop()
        return " ".join(toks[1:])

    def strip_special(self, ids) -> list:
        """Drop pad/bos/eos anywhere (for metrics over raw rollouts)."""
        special = {self.pad_idx, self.bos_idx, self.eos_idx}
        return [int(i) for i in ids if int(i) not in special]
