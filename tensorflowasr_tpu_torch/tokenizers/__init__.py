"""Tokenizers: characters, wordpiece and sentencepiece (counterpart of
``tensorflowasr_tpu/tokenizers/__init__.py``). Tokenization runs on the
host; the card takes int token ids. Importing this package needs neither
HF ``tokenizers`` nor PyYAML: the wordpiece tokenizer and sentencepiece's
``build`` import HF ``tokenizers`` when they run."""

from __future__ import annotations

from tensorflowasr_tpu_torch.configs import Config, DecoderConfig
from tensorflowasr_tpu_torch.tokenizers.base import Tokenizer
from tensorflowasr_tpu_torch.tokenizers.char import ENGLISH_CHARACTERS, CharTokenizer
from tensorflowasr_tpu_torch.tokenizers.sentencepiece import SentencePieceTokenizer
from tensorflowasr_tpu_torch.tokenizers.wordpiece import WordPieceTokenizer

TOKENIZER_TYPES = ("characters", "wordpiece", "sentencepiece")


def get(config: Config | DecoderConfig) -> Tokenizer:
    """The tokenizer of ``config.decoder_config.type`` (not yet made: call ``make()``)."""
    decoder_config = config.decoder_config if isinstance(config, Config) else config
    t = decoder_config.type
    if t == "sentencepiece":
        return SentencePieceTokenizer(decoder_config)
    if t == "wordpiece":
        return WordPieceTokenizer(decoder_config)
    if t == "characters":
        return CharTokenizer(decoder_config)
    raise ValueError(f"decoder_config.type must be in {TOKENIZER_TYPES}, received {t}")
