"""WordPiece tokenizer over HF ``tokenizers`` (counterpart of
``tensorflowasr_tpu/tokenizers/wordpiece.py``): whitespace
pre-tokenization (optionally keeping the space as a token of its own),
vocabulary building from the transcripts, blank and pad at index 0. HF
``tokenizers`` is imported by ``make`` and ``build``, not with the module.
"""

from __future__ import annotations

import os

import numpy as np

from tensorflowasr_tpu_torch.configs import DecoderConfig
from tensorflowasr_tpu_torch.tokenizers.base import Tokenizer
from tensorflowasr_tpu_torch.utils import file_util

PAD = "<pad>"  # doubles as blank at index 0 (reference keeps blank==pad==0)
UNK = "<unk>"


class WordPieceTokenizer(Tokenizer):
    def __init__(self, decoder_config: DecoderConfig):
        super().__init__(decoder_config)
        self._hf = None  # the HF tokenizers.Tokenizer

    def _vocab_path(self) -> str:
        return file_util.preprocess_paths(self.decoder_config.vocabulary)

    def make(self):
        from tokenizers import Tokenizer as HFTokenizer
        from tokenizers import decoders, models, pre_tokenizers

        path = self._vocab_path()
        if not path or not os.path.exists(path):
            raise FileNotFoundError(f"wordpiece vocabulary not found: {path} — run build() first")
        with open(path, encoding="utf-8") as f:
            head = f.read(1)
        if head == "{":  # HF tokenizers json artifact (our build() output)
            self._hf = HFTokenizer.from_file(path)
        else:
            # reference-style plain-text vocab, one token per line (the
            # reference's bert_vocab output, tokenizers.py:363-390); greedy
            # longest-match wordpiece == HF WordPiece == FastWordpiece
            with open(path, encoding="utf-8") as f:
                tokens = f.read().splitlines()
            vocab = {tok: i for i, tok in enumerate(tokens)}
            unk = self.decoder_config.unknown_token or UNK
            hf = HFTokenizer(models.WordPiece(vocab=vocab, unk_token=unk, max_input_chars_per_word=100))
            if self.decoder_config.keep_whitespace:
                hf.pre_tokenizer = pre_tokenizers.Split(" ", behavior="isolated")
            else:
                hf.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
            hf.decoder = decoders.WordPiece(prefix="##", cleanup=False)
            self._hf = hf
        self._finish_init()

    def _finish_init(self):
        vocab = self._hf.get_vocab()
        self.num_classes = len(vocab)
        self.tokens = [""] * self.num_classes
        for tok, idx in vocab.items():
            self.tokens[idx] = tok
        self.blank = self.decoder_config.blank_index
        self.initialized = True

    def build(self, *datasets):
        from tokenizers import Tokenizer as HFTokenizer
        from tokenizers import decoders, models, pre_tokenizers, trainers

        hf = HFTokenizer(models.WordPiece(unk_token=UNK))
        if self.decoder_config.keep_whitespace:
            # Whitespace becomes part of tokens: split pattern keeps " " as a token.
            hf.pre_tokenizer = pre_tokenizers.Split(" ", behavior="isolated")
        else:
            hf.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
        trainer = trainers.WordPieceTrainer(
            vocab_size=self.decoder_config.vocab_size,
            special_tokens=[PAD, UNK],
            continuing_subword_prefix="##",
            show_progress=False,
        )
        hf.train_from_iterator(self.generator(*datasets), trainer=trainer)
        hf.decoder = decoders.WordPiece(prefix="##", cleanup=False)
        path = self._vocab_path()
        hf.save(path)
        self._hf = hf
        self._finish_init()

    def tokenize(self, text: str) -> np.ndarray:
        text = self.normalize_text(text, self.decoder_config)
        ids = self._hf.encode(text).ids
        return np.asarray(ids, np.int32)

    def detokenize(self, indices) -> str:
        indices = self.normalize_indices(indices)
        ids = [int(i) for i in np.asarray(indices).reshape(-1) if int(i) != self.blank]
        if self.decoder_config.keep_whitespace:
            # whitespace is its own token: concatenate pieces directly (the
            # HF decoder would insert extra separators between words)
            pieces = [self.tokens[i] for i in ids if 0 <= i < self.num_classes]
            text = "".join(p[2:] if p.startswith("##") else p for p in pieces if p not in (PAD, UNK))
        else:
            text = self._hf.decode(ids, skip_special_tokens=True)
        return text.strip()

    def _token_text_for_upoints(self, index: int) -> str:
        tok = self.tokens[index]
        if tok in (PAD, UNK):
            return ""
        if tok.startswith("##"):
            return tok[2:]
        # leading space marks a word boundary for codepoint reassembly
        return (" " + tok) if not self.decoder_config.keep_whitespace else tok
