"""Character tokenizer (counterpart of ``tensorflowasr_tpu/tokenizers/char.py``):
the built-in English set (blank, space, a-z, apostrophe: 29 classes) or a
vocabulary file such as ``examples/datasets/librispeech/characters/english.vocab``.
"""

from __future__ import annotations

import codecs
import os
import unicodedata

import numpy as np

from tensorflowasr_tpu_torch.tokenizers.base import Tokenizer
from tensorflowasr_tpu_torch.utils import file_util

ENGLISH_CHARACTERS = [
    "<blank>",
    " ",
    *list("abcdefghijklmnopqrstuvwxyz"),
    "'",
]


class CharTokenizer(Tokenizer):
    def make(self):
        lines: list[str]
        if self.decoder_config.vocabulary is not None and os.path.exists(self.decoder_config.vocabulary):
            with codecs.open(self.decoder_config.vocabulary, "r", "utf-8") as fin:
                lines = fin.readlines()
        else:
            lines = list(ENGLISH_CHARACTERS)
        self.tokens = []
        for line in lines:
            line = unicodedata.normalize(self.decoder_config.normalization_form, line.lower()).strip("\n")
            if line.startswith("#") or not line:
                continue
            if line == "<blank>":
                line = ""  # blank token renders as empty string
            self.tokens.append(line)
        if self.blank is None:
            self.blank = len(self.tokens)
        self.num_classes = len(self.tokens)
        self._tok2idx = {t: i for i, t in enumerate(self.tokens)}
        self.initialized = True

    def build(self, *datasets):
        vocab: set[str] = set()
        for text in self.generator(*datasets):
            vocab.update(text)
        vocab_file = file_util.preprocess_paths(self.decoder_config.vocabulary)
        with open(vocab_file, "w", encoding="utf-8") as f:
            f.write("<blank>\n")
            for ch in sorted(vocab):
                f.write(ch + "\n")

    def tokenize(self, text: str) -> np.ndarray:
        text = self.normalize_text(text, self.decoder_config)
        ids = [self._tok2idx.get(ch, self.blank) for ch in text]
        return np.asarray(ids, np.int32)

    def detokenize(self, indices) -> str:
        indices = self.normalize_indices(indices)
        return "".join(self.tokens[i] for i in np.asarray(indices).reshape(-1) if 0 <= i < self.num_classes)
