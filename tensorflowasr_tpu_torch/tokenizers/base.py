"""Abstract tokenizer with the reference's text normalization
(counterpart of ``tensorflowasr_tpu/tokenizers/base.py``).

Normalization: remove U+2047, unicode-normalize (NFKC by default),
control and format characters → space, strip the unknown and pad token
strings, squeeze spaces, lower-case, strip. Token ids are int32 numpy
arrays; -1 padding reads as blank (``normalize_indices``).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Iterable, Sequence

import numpy as np

from tensorflowasr_tpu_torch.configs import DecoderConfig
from tensorflowasr_tpu_torch.utils import file_util


def _control_chars_to_space(text: str) -> str:
    return "".join(" " if unicodedata.category(c) in ("Cc", "Cf") else c for c in text)


class Tokenizer:
    def __init__(self, decoder_config: DecoderConfig):
        self.scorer = None
        self.decoder_config = decoder_config
        if self.decoder_config.vocabulary:
            self.decoder_config.vocabulary = file_util.preprocess_paths(self.decoder_config.vocabulary)
        self.blank: int = self.decoder_config.blank_index
        self.tokens: list[str] = []
        self.num_classes: int | None = None
        self.max_length = 0
        self.initialized = False

    # ------------------------------ vocabulary ------------------------------ #

    def make(self):
        """Load/construct the vocabulary so tokenize/detokenize work."""
        raise NotImplementedError()

    def build(self, *datasets):
        """Train/collect the vocabulary from dataset transcripts."""
        raise NotImplementedError()

    def generator(self, *datasets) -> Iterable[str]:
        for dataset in datasets:
            dataset.read_entries()
            for text in dataset.vocab_generator():
                yield self.normalize_text(text, self.decoder_config)

    # ------------------------------- lengths -------------------------------- #

    @property
    def shape(self) -> list:
        return [self.max_length if self.max_length > 0 else None]

    @property
    def prepand_shape(self) -> list:
        return [self.max_length + 1 if self.max_length > 0 else None]

    def update_length(self, length: int):
        self.max_length = max(self.max_length, length)

    def reset_length(self):
        self.max_length = 0

    # ----------------------------- normalization ---------------------------- #

    @classmethod
    def normalize_text(cls, text: str, decoder_config: DecoderConfig) -> str:
        text = text.replace("⁇", "")
        text = unicodedata.normalize(decoder_config.normalization_form, text)
        text = _control_chars_to_space(text)
        if decoder_config.unknown_token:
            text = text.replace(decoder_config.unknown_token, "")
        if decoder_config.pad_token:
            text = text.replace(decoder_config.pad_token, "")
        text = re.sub(r" +", " ", text)
        text = text.lower().strip()
        return text

    def add_scorer(self, scorer=None):
        self.scorer = scorer

    # ------------------------------ core API -------------------------------- #

    def normalize_indices(self, indices: np.ndarray) -> np.ndarray:
        """Replace -1 padding with blank index (reference :204-213)."""
        indices = np.asarray(indices, np.int32)
        return np.where(indices == -1, np.int32(self.blank), indices)

    def prepand_blank(self, indices: Sequence[int] | np.ndarray) -> np.ndarray:
        """Prepend blank for transducer prediction-network input."""
        return np.concatenate([[np.int32(self.blank)], np.asarray(indices, np.int32)])

    def tokenize(self, text: str) -> np.ndarray:
        raise NotImplementedError()

    def detokenize(self, indices) -> str:
        raise NotImplementedError()

    def detokenize_batch(self, indices, lengths=None) -> list[str]:
        out = []
        indices = np.asarray(indices)
        for i, row in enumerate(indices):
            if lengths is not None:
                row = row[: int(np.asarray(lengths)[i])]
            out.append(self.detokenize(row))
        return out

    # -------------------------- in-graph detokenize -------------------------- #

    @property
    def upoints(self) -> np.ndarray:
        """[num_classes, max_token_chars] int32 unicode codepoints, 0-padded.

        Enables jit-compatible detokenization to codepoints (export path,
        reference ``detokenize_unicode_points`` tokenizers.py:251-264).
        """
        if not self.initialized:
            raise RuntimeError("call make() first")
        toks = [self._token_text_for_upoints(i) for i in range(self.num_classes)]
        maxlen = max((len(t) for t in toks), default=1) or 1
        table = np.zeros((self.num_classes, maxlen), np.int32)
        for i, t in enumerate(toks):
            for j, ch in enumerate(t):
                table[i, j] = ord(ch)
        return table

    def _token_text_for_upoints(self, index: int) -> str:
        return self.tokens[index] if index < len(self.tokens) else ""

    def detokenize_unicode_points(self, indices) -> np.ndarray:
        """Map token ids → flattened unicode codepoints (host reference impl).

        The jit path gathers from ``upoints`` inside the graph; this host
        version defines the semantics and is used in tests.
        """
        table = self.upoints
        indices = self.normalize_indices(indices)
        pts = table[indices]  # [..., maxchar]
        return pts
