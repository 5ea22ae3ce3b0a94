"""Sectioned configs (counterpart of ``tensorflowasr_tpu/configs.py``).

A ``Config`` splits a user config into ``decoder_config``,
``model_config``, ``data_config`` and ``learning_config``; every known key
has its default, and unknown keys become attributes, so the example
``.yml.j2`` files load unmodified. A path loads through
``utils/file_util.load_yaml`` (Jinja2 and PyYAML); a dict needs neither.
"""

from __future__ import annotations

import json
from typing import Union

from tensorflowasr_tpu_torch.utils import file_util


class _AttrConfig:
    """Consumes its known keys; the rest become attributes."""

    def _absorb(self, config: dict):
        for k, v in config.items():
            setattr(self, k, v)

    def to_dict(self) -> dict:
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}

    def __repr__(self):
        return f"{type(self).__name__}({json.dumps(self.to_dict(), indent=2, default=str)})"


class DecoderConfig(_AttrConfig):
    def __init__(self, config: dict | None = None):
        config = dict(config or {})
        self.type: str = config.pop("type", "wordpiece")

        self.blank_index: int = config.pop("blank_index", 0)
        self.pad_token: str = config.pop("pad_token", "<pad>")
        self.pad_index: int = config.pop("pad_index", -1)
        self.unknown_token: str = config.pop("unknown_token", "<unk>")
        self.unknown_index: int = config.pop("unknown_index", 0)
        self.bos_token: str = config.pop("bos_token", "<s>")
        self.bos_index: int = config.pop("bos_index", -1)
        self.eos_token: str = config.pop("eos_token", "</s>")
        self.eos_index: int = config.pop("eos_index", -1)

        self.beam_width: int = config.pop("beam_width", 0)
        self.norm_score: bool = config.pop("norm_score", True)
        self.lm_config: dict = config.pop("lm_config", {})

        self.model_type: str = config.pop("model_type", "unigram")
        self.vocabulary: str | None = config.pop("vocabulary", None)
        self.vocab_size: int = config.pop("vocab_size", 1000)
        self.max_token_length: int = config.pop("max_token_length", 50)
        self.max_unique_chars: int | None = config.pop("max_unique_chars", None)
        self.num_iterations: int = config.pop("num_iterations", 4)
        self.reserved_tokens: list | None = config.pop("reserved_tokens", None)
        self.normalization_form: str = config.pop("normalization_form", "NFKC")
        self.keep_whitespace: bool = config.pop("keep_whitespace", False)
        self.max_sentence_length: int = config.pop("max_sentence_length", 1048576)
        self.max_sentencepiece_length: int = config.pop("max_sentencepiece_length", 16)
        self.character_coverage: float = config.pop("character_coverage", 1.0)
        self._absorb(config)


class DatasetConfig(_AttrConfig):
    def __init__(self, config: dict | None = None):
        config = dict(config or {})
        self.name: str = config.pop("name", "")
        self.enabled: bool = config.pop("enabled", True)
        self.stage: str | None = config.pop("stage", None)
        self.data_paths = config.pop("data_paths", None)
        self.tfrecords_dir: str | None = config.pop("tfrecords_dir", None)
        self.tfrecords_shards: int = config.pop("tfrecords_shards", 16)
        self.tfrecords_buffer_size: int = config.pop("tfrecords_buffer_size", 32 * 1024 * 1024)
        self.shuffle: bool = config.pop("shuffle", False)
        self.cache: bool = config.pop("cache", False)
        self.drop_remainder: bool = config.pop("drop_remainder", True)
        self.buffer_size: int = config.pop("buffer_size", 1000)
        self.metadata: str | None = config.pop("metadata", None)
        self.sample_rate: int = config.pop("sample_rate", 16000)
        self._absorb(config)


class DataConfig(_AttrConfig):
    def __init__(self, config: dict | None = None):
        config = dict(config or {})
        self.train_dataset_config = DatasetConfig(config.pop("train_dataset_config", {}))
        self.eval_dataset_config = DatasetConfig(config.pop("eval_dataset_config", {}))
        self.test_dataset_configs = [DatasetConfig(c) for c in config.pop("test_dataset_configs", [])]
        single = config.pop("test_dataset_config", None)
        if single:
            self.test_dataset_configs.append(DatasetConfig(single))
        self._absorb(config)


class LearningConfig(_AttrConfig):
    def __init__(self, config: dict | None = None):
        config = dict(config or {})
        self.pretrained = config.pop("pretrained", None)
        self.optimizer_config: dict = config.pop("optimizer_config", {})
        self.gwn_config = config.pop("gwn_config", None)
        self.gradn_config = config.pop("gradn_config", None)
        self.batch_size: int = config.pop("batch_size", 2)
        self.ga_steps: int | None = config.pop("ga_steps", None)
        self.num_epochs: int = config.pop("num_epochs", 300)
        self.callbacks: list = config.pop("callbacks", [])
        self._absorb(config)


class Config(_AttrConfig):
    """Top-level config for training, testing and inference: a path to a
    ``.yml``/``.yml.j2`` file (``kwargs`` are its template variables) or a
    dict of the parsed sections. ``training=False`` drops the learning config."""

    def __init__(self, data: Union[str, dict], training: bool = True, **kwargs):
        config = dict(data if isinstance(data, dict) else file_util.load_yaml(data, **kwargs))
        self.decoder_config = DecoderConfig(config.pop("decoder_config", {}))
        self.model_config: dict = config.pop("model_config", {})
        self.data_config = DataConfig(config.pop("data_config", {}))
        learning = config.pop("learning_config", {})
        self.learning_config = LearningConfig(learning) if training else None
        self._absorb(config)

    def __str__(self) -> str:
        def default(x):
            try:
                return {k: v for k, v in vars(x).items() if not str(k).startswith("_")}
            except TypeError:
                return str(x)

        return json.dumps(vars(self), indent=2, default=default)
