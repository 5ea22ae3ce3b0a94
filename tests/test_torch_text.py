"""The port's configs, registry and tokenizers against the JAX package's, on the CPU.

- Every example ``.yml.j2`` (models and datasets) parses to the same
  sections through both ``Config`` classes, rendered with the same
  ``datadir`` and ``modeldir``; the port's recipe functions equal its own
  loader's ``learning_config``.
- ``build_model`` of each model example gives the port's class with JAX's
  parameter count (``jax.eval_shape`` of ``init``, nothing compiled); every
  registry name resolves, and the three transducers built with a layer the
  port took last (a GRU, VGG subsampling) have JAX's parameter names and
  shapes.
- Tokenizers (char with the bundled vocabulary, SentencePiece unigram and
  BPE ``.model`` files, WordPiece with and without ``keep_whitespace``)
  give equal ids, texts, blank handling and codepoint tables, exactly, on
  the corpus of ``tests/test_tokenizers.py`` and random Unicode strings,
  with each vocabulary built by one package and loaded by the other.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu import tokenizers as jtokenizers
from tensorflowasr_tpu.configs import Config as JConfig
from tensorflowasr_tpu.configs import DecoderConfig as JDecoderConfig
from tensorflowasr_tpu.models import build_model as jbuild_model
from tensorflowasr_tpu.tokenizers import spm as jspm
from tensorflowasr_tpu_torch import bridge, registry, tokenizers
from tensorflowasr_tpu_torch.configs import Config, DecoderConfig
from tensorflowasr_tpu_torch.models import build_model
from tensorflowasr_tpu_torch.models.ctc.conformer import ConformerCtc, conformer_ctc_small_learning_config
from tensorflowasr_tpu_torch.models.ctc.deepspeech2 import DeepSpeech2
from tensorflowasr_tpu_torch.models.ctc.jasper import Jasper
from tensorflowasr_tpu_torch.models.ctc.transformer import TransformerCtc, transformer_ctc_base_learning_config
from tensorflowasr_tpu_torch.models.transducer.conformer import (Conformer, conformer_small_learning_config,
                                                                 conformer_small_streaming_learning_config)
from tensorflowasr_tpu_torch.models.transducer.contextnet import ContextNet
from tensorflowasr_tpu_torch.models.transducer.rnnt import RnnTransducer
from tensorflowasr_tpu_torch.models.transducer.transformer import TransformerTransducer
from tensorflowasr_tpu_torch.tokenizers import spm
from tensorflowasr_tpu_torch.utils import file_util
from tests.test_tokenizers import CORPUS, FakeDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "examples", "**", "*.yml.j2"), recursive=True))
ENGLISH_VOCAB = os.path.join(REPO, "examples", "datasets", "librispeech", "characters", "english.vocab")


def _plain(x):
    """A config object tree as nested dicts and lists."""
    if hasattr(x, "to_dict"):
        return {k: _plain(v) for k, v in x.to_dict().items()}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


def _random_strings(seed: int, n: int = 60) -> list[str]:
    """Random Unicode: ASCII letters and spaces, accents, fullwidth and
    ligature forms (NFKC folds them), control and format characters, the
    U+2047 marker and the pad/unknown token strings."""
    rng = np.random.default_rng(seed)
    pool = list("abcdefghijklmnopqrstuvwxyz      'ABCXYZ") + ["é", "Ü", "ß", "ﬁ", "Ａ", "ｂ", "①", "\t", "\n", "​", "­", "⁇", "<unk>", "<pad>", "ö", "ñ"]
    return ["".join(pool[i] for i in rng.integers(0, len(pool), rng.integers(0, 40))) for _ in range(n)]


TEXTS = sorted(set(CORPUS)) + _random_strings(0)


# ------------------------------- configs ---------------------------------- #


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_config_sections_equal_jax(tmp_path, example):
    """Each section of the port's parse equals JAX's, with the same template variables."""
    kw = {"datadir": str(tmp_path / "data"), "modeldir": str(tmp_path / "models")}
    path = os.path.join(REPO, example)
    ours, theirs = Config(path, **kw), JConfig(path, **kw)
    for section in ("decoder_config", "model_config", "data_config", "learning_config"):
        assert _plain(getattr(ours, section)) == _plain(getattr(theirs, section)), section
    assert _plain(ours) == _plain(theirs)
    assert _plain(Config(path, training=False, **kw)) == _plain(JConfig(path, training=False, **kw))


def test_load_yaml_reads_scientific_notation_and_repodir(tmp_path):
    """``1e-9`` (no decimal point) parses as a float, ``repodir`` is the repository
    root, and a dict config needs no loader."""
    cfg = tmp_path / "c.yml.j2"
    cfg.write_text("a: 1e-9\nb: 1.5e+3\nc: '1e-9'\nroot: {{ repodir }}\ndata: {{ datadir }}\n")
    got = file_util.load_yaml(str(cfg), datadir="/d")
    assert got == {"a": 1e-9, "b": 1500.0, "c": "1e-9", "root": REPO, "data": "/d"}
    assert file_util.REPODIR == REPO
    assert Config({"decoder_config": {"type": "characters"}}).decoder_config.type == "characters"


def test_json_and_atomic_write(tmp_path):
    """``save_json`` creates the parent directories; ``atomic_write`` replaces
    the file only when the block ends, and leaves it as it was when the block raises."""
    target = tmp_path / "a" / "b.json"
    file_util.save_json(target, {"x": [1, 2]})
    assert file_util.load_json(target) == {"x": [1, 2]}
    with file_util.atomic_write(target) as f:
        f.write('{"x": 3}')
        assert file_util.load_json(target) == {"x": [1, 2]}
    assert file_util.load_json(target) == {"x": 3}
    with pytest.raises(RuntimeError):
        with file_util.atomic_write(target) as f:
            f.write("partial")
            raise RuntimeError("interrupted")
    assert file_util.load_json(target) == {"x": 3} and os.listdir(tmp_path / "a") == ["b.json"]


@pytest.mark.parametrize("example, learning", [("transducer/conformer/small", conformer_small_learning_config),
                                               ("transducer/conformer/small-streaming", conformer_small_streaming_learning_config),
                                               ("ctc/conformer/small", conformer_ctc_small_learning_config),
                                               ("ctc/transformer/base", transformer_ctc_base_learning_config)])
def test_recipe_functions_equal_the_ports_config_loader(tmp_path, example, learning):
    cfg = Config(os.path.join(REPO, "examples", "models", example + ".yml.j2"), modeldir=str(tmp_path))
    assert (learning(str(tmp_path)) if example == "transducer/conformer/small" else learning()) == cfg.learning_config.to_dict()


# ------------------------------- registry --------------------------------- #

PORTED = {
    "examples/models/transducer/conformer/small.yml.j2": Conformer,
    "examples/models/transducer/conformer/small-streaming.yml.j2": Conformer,
    "examples/models/ctc/conformer/small.yml.j2": ConformerCtc,
    "examples/models/ctc/conformer/small-streaming.yml.j2": ConformerCtc,
    "examples/models/ctc/transformer/base.yml.j2": TransformerCtc,
    "examples/models/ctc/transformer/base-streaming.yml.j2": TransformerCtc,
    "examples/models/ctc/deepspeech2/base.yml.j2": DeepSpeech2,
    "examples/models/ctc/deepspeech2/uni.yml.j2": DeepSpeech2,
    "examples/models/ctc/jasper/base.yml.j2": Jasper,
    "examples/models/transducer/transformer/base.yml.j2": TransformerTransducer,
    "examples/models/transducer/rnnt/small.yml.j2": RnnTransducer,
    "examples/models/transducer/contextnet/small.yml.j2": ContextNet,
}


def _jax_param_count(model_config: dict, vocab_size: int) -> int:
    jm = jbuild_model(model_config, vocab_size=vocab_size)
    n = 1600
    ti = jschemas.TrainInput(jax.ShapeDtypeStruct((1, n), jnp.float32), jax.ShapeDtypeStruct((1,), jnp.int32),
                             jax.ShapeDtypeStruct((1, 3), jnp.int32), jax.ShapeDtypeStruct((1,), jnp.int32))
    shapes = jax.eval_shape(lambda x: jm.init({"params": jax.random.PRNGKey(0)}, x, train=False), ti)
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("example", sorted(PORTED))
def test_build_model_gives_the_port_class_with_jax_parameter_count(tmp_path, example):
    cfg = Config(os.path.join(REPO, example), modeldir=str(tmp_path))
    vocab = cfg.decoder_config.vocab_size
    model = build_model(cfg.model_config, vocab_size=vocab, device="cpu")
    assert type(model) is PORTED[example]
    assert model.vocab_size == vocab
    assert sum(p.numel() for p in model.parameters()) == _jax_param_count(cfg.model_config, vocab)


@pytest.mark.parametrize("prefix", ["tensorflow_asr.", "tensorflowasr_tpu.", "tensorflowasr_tpu_torch."])
def test_registry_prefixes_and_bare_names(prefix):
    assert registry.get(prefix + "models.transducer.conformer>Conformer") is Conformer
    assert registry.get(prefix + "models.ctc.conformer>Conformer") is ConformerCtc
    assert registry.get(prefix + "models.ctc.transformer>Transformer") is TransformerCtc
    assert registry.get("Conformer") is Conformer and registry.get("ConformerCtc") is ConformerCtc and registry.get("TransformerCtc") is TransformerCtc
    assert registry.get(prefix + "models.ctc.deepspeech2>DeepSpeech2") is DeepSpeech2 and registry.get(prefix + "models.ctc.jasper>Jasper") is Jasper
    with pytest.raises(KeyError):
        registry.get(prefix + "models.ctc.nothing>Nothing")


@pytest.mark.parametrize("class_name, cls", [
    ("tensorflow_asr.models.ctc.deepspeech2>DeepSpeech2", DeepSpeech2),
    ("tensorflowasr_tpu.models.ctc.jasper>Jasper", Jasper),
    ("Jasper", Jasper),
])
def test_ctc_family_names_resolve_to_the_port_classes(class_name, cls):
    """The names that raised until the rest of the CTC family was ported (JAX's registry names and aliases)."""
    assert registry.get(class_name) is cls
    assert registry.get("DeepSpeech2") is DeepSpeech2


# each transducer's example with a layer the port took last: a GRU (the prediction net's or the encoder's), VGG subsampling
UNPORTED_LAYERS = {"ContextNet": ("examples/models/transducer/contextnet/small.yml.j2", {"prediction_rnn_type": "gru"}),
                   "RnnTransducer": ("examples/models/transducer/rnnt/small.yml.j2", {"encoder_rnn_type": "gru"}),
                   "TransformerTransducer": ("examples/models/transducer/transformer/base.yml.j2",
                                             {"encoder_subsampling": {"class_name": "tensorflow_asr.models.layers.subsampling>VggSubsampling",
                                                                      "config": {"filters": [32, 64]}}})}


def _jax_param_shapes(model_config: dict, vocab_size: int) -> dict:
    """JAX's parameter tree (``jax.eval_shape`` of ``init``, nothing compiled) through ``bridge``: port name → shape."""
    jm = jbuild_model(model_config, vocab_size=vocab_size)
    ti = jschemas.TrainInput(jax.ShapeDtypeStruct((1, 1600), jnp.float32), jax.ShapeDtypeStruct((1,), jnp.int32),
                             jax.ShapeDtypeStruct((1, 3), jnp.int32), jax.ShapeDtypeStruct((1,), jnp.int32))
    shapes = jax.eval_shape(lambda x: jm.init({"params": jax.random.PRNGKey(0)}, x, train=False), ti)
    zeros = jax.tree_util.tree_map(lambda leaf: np.zeros(leaf.shape, np.float32), shapes)
    return {k: tuple(v.shape) for k, v in bridge.state_dict_from_flax(zeros).items()}


@pytest.mark.parametrize("class_name, item", [
    ("tensorflow_asr.models.transducer.contextnet>ContextNet", "The other transducers, encoders and layers"),
    ("tensorflow_asr.models.transducer.rnnt>RnnTransducer", "The other transducers, encoders and layers"),
    ("tensorflowasr_tpu_torch.models.transducer.transformer>TransformerTransducer", "The other transducers, encoders and layers"),
])
def test_unported_families_raise_with_their_roadmap_item(tmp_path, class_name, item):
    """The three transducer names resolve to the port's classes, and each
    builds with the layer that raised until the port took it (the ROADMAP
    item ``item``), every parameter and statistic named and shaped as JAX's
    tree through ``bridge``."""
    cls = registry.get(class_name)
    assert cls is registry.get(cls.__name__) and cls.__module__ == "tensorflowasr_tpu_torch." + class_name.split(".", 1)[1].split(">")[0]
    example, layer = UNPORTED_LAYERS[cls.__name__]
    cfg = Config(os.path.join(REPO, example), modeldir=str(tmp_path))
    config = {"class_name": class_name, "config": {**cfg.model_config["config"], **layer}}
    vocab = cfg.decoder_config.vocab_size
    model = build_model(config, vocab_size=vocab, device="cpu")
    assert type(model) is cls, item
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == _jax_param_shapes(config, vocab)


# ------------------------------ tokenizers -------------------------------- #


def _same_tokenizer(ours, theirs, texts=TEXTS):
    """Ids, texts, blank handling and codepoint tables equal, exactly."""
    assert ours.num_classes == theirs.num_classes and ours.blank == theirs.blank and ours.tokens == theirs.tokens
    np.testing.assert_array_equal(ours.upoints, theirs.upoints)
    for text in texts:
        assert ours.normalize_text(text, ours.decoder_config) == theirs.normalize_text(text, theirs.decoder_config), repr(text)
        ids = ours.tokenize(text)
        np.testing.assert_array_equal(ids, theirs.tokenize(text), err_msg=repr(text))
        assert ids.dtype == np.int32
        assert ours.detokenize(ids) == theirs.detokenize(ids)
        np.testing.assert_array_equal(ours.prepand_blank(ids), theirs.prepand_blank(ids))
        padded = np.concatenate([ids, -np.ones(3, np.int32)])
        np.testing.assert_array_equal(ours.normalize_indices(padded), theirs.normalize_indices(padded))
        assert ours.detokenize(padded) == theirs.detokenize(padded)
    batch = np.stack([np.resize(ours.tokenize(t) if len(ours.tokenize(t)) else np.zeros(1, np.int32), 12) for t in texts[:8]])
    assert ours.detokenize_batch(batch, [3, 12, 0, 5, 7, 1, 2, 12]) == theirs.detokenize_batch(batch, [3, 12, 0, 5, 7, 1, 2, 12])
    np.testing.assert_array_equal(ours.detokenize_unicode_points(batch), theirs.detokenize_unicode_points(batch))


@pytest.mark.parametrize("vocabulary", [None, ENGLISH_VOCAB])
def test_char_tokenizer_equals_jax(vocabulary):
    ours = tokenizers.get(DecoderConfig({"type": "characters", "vocabulary": vocabulary}))
    theirs = jtokenizers.get(JDecoderConfig({"type": "characters", "vocabulary": vocabulary}))
    ours.make()
    theirs.make()
    assert ours.num_classes == 29
    _same_tokenizer(ours, theirs)


def test_char_vocabulary_built_by_the_port_loads_in_jax(tmp_path):
    dc = {"type": "characters", "vocabulary": str(tmp_path / "chars.vocab")}
    ours = tokenizers.get(DecoderConfig(dc))
    ours.build(FakeDataset(CORPUS))
    ours.make()
    theirs = jtokenizers.get(JDecoderConfig(dc))
    theirs.make()
    _same_tokenizer(ours, theirs)


@pytest.mark.parametrize("model_type", ["unigram", "bpe"])
@pytest.mark.parametrize("built_by", ["jax", "port"])
def test_sentencepiece_model_built_by_one_loads_in_the_other(tmp_path, model_type, built_by):
    """A ``.model`` built by one package's ``build`` and made by the other's ``make``: equal ids."""
    dc = {"type": "sentencepiece", "model_type": model_type, "vocab_size": 80, "vocabulary": str(tmp_path / "sp.model")}
    build_side = tokenizers.get(DecoderConfig(dc)) if built_by == "port" else jtokenizers.get(JDecoderConfig(dc))
    build_side.build(FakeDataset(CORPUS))
    ours, theirs = tokenizers.get(DecoderConfig(dc)), jtokenizers.get(JDecoderConfig(dc))
    ours.make()
    theirs.make()
    assert ours._spm is not None and ours._hf is None
    _same_tokenizer(ours, theirs)
    assert ours.detokenize(ours.tokenize("the quick brown fox")) == "the quick brown fox"


@pytest.mark.parametrize("model_type", ["unigram", "bpe"])
def test_spm_parse_then_serialise_is_the_identity(tmp_path, model_type):
    dc = {"type": "sentencepiece", "model_type": model_type, "vocab_size": 80, "vocabulary": str(tmp_path / "sp.model")}
    jtokenizers.get(JDecoderConfig(dc)).build(FakeDataset(CORPUS))
    data = (tmp_path / "sp.model").read_bytes()
    model = spm.SentencePieceModel.parse(data)
    assert model.serialize() == data
    assert jspm.SentencePieceModel.parse(data).serialize() == data
    assert (model.pieces, model.scores, model.types) == (jspm.SentencePieceModel.parse(data).pieces, jspm.SentencePieceModel.parse(data).scores,
                                                         jspm.SentencePieceModel.parse(data).types)


@pytest.mark.parametrize("keep_whitespace", [False, True])
@pytest.mark.parametrize("built_by", ["jax", "port"])
def test_wordpiece_built_by_one_loads_in_the_other(tmp_path, keep_whitespace, built_by):
    dc = {"type": "wordpiece", "vocab_size": 150, "keep_whitespace": keep_whitespace, "vocabulary": str(tmp_path / "wp.json")}
    build_side = tokenizers.get(DecoderConfig(dc)) if built_by == "port" else jtokenizers.get(JDecoderConfig(dc))
    build_side.build(FakeDataset(CORPUS))
    ours, theirs = tokenizers.get(DecoderConfig(dc)), jtokenizers.get(JDecoderConfig(dc))
    ours.make()
    theirs.make()
    _same_tokenizer(ours, theirs)


def test_wordpiece_plain_text_vocabulary_equals_jax(tmp_path):
    """A reference-style vocabulary, one token a line."""
    vocab = tmp_path / "wp.vocab"
    vocab.write_text("\n".join(["<pad>", "<unk>", "hello", "world", "the", "quick", "##s", "##ing", "h", "##e", "##l", "##o", "w", "##r", "##d"]) + "\n")
    dc = {"type": "wordpiece", "vocabulary": str(vocab)}
    ours, theirs = tokenizers.get(DecoderConfig(dc)), jtokenizers.get(JDecoderConfig(dc))
    ours.make()
    theirs.make()
    _same_tokenizer(ours, theirs)


def test_tokenizer_type_is_checked():
    with pytest.raises(ValueError, match="decoder_config.type"):
        tokenizers.get(DecoderConfig({"type": "bytes"}))
