"""The port reads the JAX package's orbax checkpoints, on the CPU.

- (a) the native zstd decoder (``native/zstd_decoder.cc``) equals its plain
  version and ``zstandard`` (skipped where that is absent) on a
  ``hypothesis``-drawn spread of inputs (levels 1-19, 0 to about 1 MB,
  repetitive and random data, several frames, the checksum on and off) and
  on fixed inputs that reach every block, literal and sequence mode; a
  flipped byte, a truncated stream and a dictionary frame raise; a failed
  build raises;
- (b) ``convert/orbax.py`` equals ``StandardCheckpointer().restore`` leaf by
  leaf and bit for bit (dtype, shape, value) on what the JAX package's
  writers produce for a tiny Conformer-T and a tiny Conformer-CTC: the
  ``train`` command's ``CheckpointManager`` (2 steps; its root and one step),
  ``save``, ``utils convert_checkpoint``; and on a bf16 tree with 0-d and
  empty leaves saved with OCDBT and with ``use_ocdbt=False``; zarr v2 arrays
  of several chunks (cut edge chunks, unwritten chunks at ``fill_value``,
  zstd and raw, every dtype read) equal tensorstore's read; a zarr v3 item,
  a corrupt node and a dictionary-coded chunk raise with their reason;
- (c) ``python -m tensorflowasr_tpu_torch test --checkpoint <JAX dir>
  --device cpu`` writes the JAX ``test``'s greedy hypotheses and WER/CER;
  ``save`` and ``export`` take the JAX directory too;
- (d) a warm start from a JAX ``Trainer`` directory into a port model with
  one more block loads the shared tensors, skips the rest and equals JAX's
  warm start on the shared names;
- (e) the flagship's variables at full width (JAX ``model.init``, saved as
  ``scripts/save.py`` saves them) load strictly into the port's flagship,
  every tensor equal; the native decoder's throughput on them is printed;
- the committed fixture ``tests/data/jax_orbax_conformer_t/`` (written by
  :func:`write_fixture`: ``python -m tests.test_torch_orbax --write-fixture``)
  reads as orbax reads it and the port on the CPU reproduces its recorded
  JAX outputs; the port's example inference scripts give the JAX examples'
  transcripts on it.

JAX runs its XLA routes here (``TFASR_{FF,CONV,ATTN,LOSS}_IMPL=xla``).
"""

from __future__ import annotations

import os
import random
import shutil
import struct
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "jax_orbax_conformer_t")
FIXTURE_SECONDS = 1.0
FIXTURE_LENGTHS = (16000, 12000)
XLA_ROUTES = {f"TFASR_{k}_IMPL": "xla" for k in ("FF", "CONV", "ATTN", "LOSS")}

# A Conformer-T whose widths every serving kernel takes in f32 (log-mel at
# nfft 512, kernel B, the FF, conv_front and conv_back, the fused decode of
# an embedding + LSTM prediction net with an add/tanh joint), small enough
# that its orbax checkpoint stays under 256 KB.
FIXTURE_CONFIG = """\
decoder_config:
  type: characters
  blank_index: 0

model_config:
  class_name: tensorflow_asr.models.transducer.conformer>Conformer
  config:
    name: conformer-t-fixture
    speech_config: {sample_rate: 16000, frame_ms: 25, stride_ms: 10, nfft: 512, num_feature_bins: 40, feature_type: log_mel_spectrogram}
    encoder_subsampling:
      class_name: tensorflow_asr.models.layers.subsampling>Conv2dSubsampling
      config: {filters: [8, 8], kernels: [3, 3], strides: [2, 2], paddings: [causal, causal], norms: [batch, batch], activations: [swish, swish]}
    encoder_dmodel: 32
    encoder_num_blocks: 1
    encoder_head_size: 8
    encoder_num_heads: 4
    encoder_mha_type: relmha
    encoder_kernel_size: 7
    encoder_ffm_scale_factor: 2
    encoder_dropout: 0.0
    encoder_padding: causal
    prediction_label_encode_mode: embedding
    prediction_embed_dim: 8
    prediction_num_rnns: 1
    prediction_rnn_units: 32
    prediction_rnn_type: lstm
    prediction_layer_norm: true
    prediction_projection_units: 0
    joint_dim: 32
    prejoint_encoder_linear: true
    prejoint_prediction_linear: true
    postjoint_linear: false
    joint_activation: tanh
    joint_mode: add
    blank: 0

data_config:
  test_dataset_configs:
    - name: fixture
      data_paths: [{{datadir}}/test.tsv]
      stage: test
"""


def fixture_batch() -> tuple[np.ndarray, np.ndarray]:
    """The fixture's seeded batch: 2 × 1 s of tones and noise as 16-bit PCM, and its lengths."""
    rng = np.random.default_rng(20)
    n = int(FIXTURE_SECONDS * 16000)
    t = np.arange(n) / 16000.0
    pcm = np.zeros((len(FIXTURE_LENGTHS), n), np.int16)
    for i, length in enumerate(FIXTURE_LENGTHS):
        freqs = rng.uniform(150, 3000, 4)
        x = sum(0.15 * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)) for f in freqs) + 0.02 * rng.standard_normal(n)
        pcm[i, :length] = np.round(np.clip(x[:length], -1, 1) * 32767).astype(np.int16)
    return pcm, np.asarray(FIXTURE_LENGTHS, np.int32)


def fixture_signals() -> tuple[np.ndarray, np.ndarray]:
    pcm, lengths = fixture_batch()
    return (pcm.astype(np.float32) / 32768.0).astype(np.float32), lengths


def write_fixture(out: str = FIXTURE) -> None:
    """Writes the fixture with the JAX package: ``save`` of the config's
    ``model.init`` (no checkpoint) into ``out/checkpoint``, then the JAX
    encoder's outputs and greedy tokens on :func:`fixture_batch` into
    ``out/expected.npz``."""
    os.environ.update(XLA_ROUTES)
    import jax
    import jax.numpy as jnp

    from tensorflowasr_tpu import schemas as jschemas
    from tensorflowasr_tpu.models.transducer import base as jbase
    from tensorflowasr_tpu.scripts import common as jcommon
    from tensorflowasr_tpu.scripts import main as jmain
    from tensorflowasr_tpu.scripts.test import _load_variables

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    config_path = os.path.join(out, "config.yml.j2")
    with open(config_path, "w") as f:
        f.write(FIXTURE_CONFIG)
    empty = os.path.join(out, "_modeldir")
    os.makedirs(empty)
    assert jmain(["save", "--config-path", config_path, "--modeldir", empty, "--output", os.path.join(out, "checkpoint")]) == 0
    os.rmdir(empty)

    class Args:
        checkpoint = os.path.join(out, "checkpoint")

    config = jcommon.load_config(type("A", (), {"config_path": config_path, "datadir": None, "modeldir": None})(), training=False)
    tokenizer = jcommon.build_tokenizer(config)
    model = jcommon.build_model_from_config(config, tokenizer, mxp="none")
    variables = _load_variables(model, tokenizer, Args)
    pcm, lengths = fixture_batch()
    signals, _ = fixture_signals()
    enc, enc_len, _ = model.apply(variables, jnp.asarray(signals), jnp.asarray(lengths), method=model.encode)
    out_pred = jbase.recognize(model, variables, jschemas.PredictInput(inputs=jnp.asarray(signals), inputs_length=jnp.asarray(lengths)))
    np.savez_compressed(os.path.join(out, "expected.npz"), pcm=pcm, lengths=lengths, encoded=np.asarray(enc), encoded_length=np.asarray(enc_len),
                        tokens=np.asarray(out_pred.tokens))
    del jax


# ----------------------------------------------------------------------------
# (a) zstd

import torch  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from tensorflowasr_tpu_torch.native import zstd  # noqa: E402
from tensorflowasr_tpu_torch.native.zstd import zstd_decode, zstd_decode_python  # noqa: E402

try:
    import zstandard
except ImportError:  # the comparisons with the reference library skip where it is absent
    zstandard = None

needs_zstandard = pytest.mark.skipif(zstandard is None, reason="zstandard is not installed")


def _data(kind: str, n: int, seed: int) -> bytes:
    rng = random.Random(seed)
    if kind == "random":
        return rng.randbytes(n)
    if kind == "zeros":
        return bytes(n)
    if kind == "text":
        words = [bytes(rng.choice(b"abcdefghijklmnop ") for _ in range(rng.randint(2, 9))) for _ in range(60)]
        out = b" ".join(rng.choice(words) for _ in range(n // 4 + 1))
    elif kind == "runs":
        out = b"".join(bytes([rng.randrange(4)]) * rng.randint(1, 40) for _ in range(n // 8 + 1))
    elif kind == "periodic":  # one random byte, then the same ten: every sequence code repeats (RLE modes)
        out = b"".join(bytes([rng.randrange(256)]) + b"PATTERNXYZ" for _ in range(n // 11 + 1))
    elif kind == "tokens3":  # 3-byte tokens with no literal between matches: past 0x7F00 sequences a block
        toks = [rng.randbytes(3) for _ in range(300)]
        out = b"".join(rng.choice(toks) for _ in range(n // 3 + 1))
    elif kind == "floats":
        out = np.random.default_rng(seed).standard_normal(n // 4 + 1).astype(np.float32).tobytes()
    elif kind == "small_alphabet":
        out = bytes(rng.choice(b"ab") for _ in range(n))
    else:
        raise ValueError(kind)
    return out[:n]


def _compress(data: bytes, level: int, checksum: bool, content_size: bool = True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum, write_content_size=content_size).compress(data)


KINDS = ("random", "zeros", "text", "runs", "periodic", "tokens3", "floats", "small_alphabet")


@needs_zstandard
@settings(max_examples=18, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(KINDS), size=st.one_of(st.integers(0, 4096), st.integers(4097, 1 << 17), st.integers(1 << 17, 1 << 20)),
       level=st.integers(1, 19), checksum=st.booleans(), content_size=st.booleans(), frames=st.integers(1, 3), seed=st.integers(0, 2**16))
def test_zstd_native_equals_plain_and_zstandard(kind, size, level, checksum, content_size, frames, seed):
    size = size // frames
    parts = [_data(kind, size, seed + i) for i in range(frames)]
    stream = b"".join(_compress(part, level, checksum, content_size) for part in parts)
    data = b"".join(parts)
    assert zstd_decode(stream) == data
    assert zstd_decode_python(stream) == data
    assert zstandard.ZstdDecompressor().decompressobj().decompress(stream[: len(_compress(parts[0], level, checksum, content_size))]) == parts[0]


# the fixed inputs that reach each mode: RLE blocks (zeros), treeless and 4-stream literals (text), one
# stream with direct Huffman weights (small_alphabet), RLE sequence modes (periodic), the three-byte
# sequence count (tokens3), raw blocks (random)
FIXED = {"zeros": 400_000, "text": 300_000, "small_alphabet": 300, "periodic": 33_000, "tokens3": 140_000, "random": 5000, "runs": 160_000, "floats": 200_000}


@needs_zstandard
@pytest.mark.parametrize("kind", sorted(FIXED))
def test_zstd_fixed_inputs_every_mode(kind):
    data = _data(kind, FIXED[kind], 7)
    for level in (1, 19):
        frame = _compress(data, level, checksum=True)
        assert zstd_decode(frame) == data
        assert zstd_decode_python(frame) == data


@needs_zstandard
def test_zstd_streamed_frames_and_skippable_frames():
    data = _data("text", 70_000, 3)
    cobj = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
    streamed = cobj.compress(data) + cobj.flush()  # no content size in the header
    skippable = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    stream = skippable + streamed + _compress(b"", 3, True) + streamed + skippable
    for decode in (zstd_decode, zstd_decode_python):
        assert decode(stream) == data + data


def test_zstd_rle_literals_and_blocks_by_hand():
    # a single-segment frame with content size 10: one compressed block of RLE literals ('x' × 10) and no sequences
    rle_literals = bytes.fromhex("28b52ffd") + bytes([0x20, 10]) + bytes([(3 << 3) | (2 << 1) | 1, 0, 0]) + bytes([(10 << 3) | 1, ord("x"), 0])
    # an RLE block of 5 'y' then a raw block 'ab', no content size
    blocks = bytes.fromhex("28b52ffd") + bytes([0x00, 0x00]) + bytes([(5 << 3) | (1 << 1), 0, 0]) + b"y" + bytes([(2 << 3) | 1, 0, 0]) + b"ab"
    for decode in (zstd_decode, zstd_decode_python):
        assert decode(rle_literals) == b"x" * 10
        assert decode(blocks) == b"yyyyyab"


@needs_zstandard
@pytest.mark.parametrize("where", [5, 0.25, 0.5, 0.75, -3])
def test_zstd_flipped_byte_raises(where):
    frame = bytearray(_compress(_data("text", 50_000, 1), 5, checksum=True))
    at = where if isinstance(where, int) else int(len(frame) * where)
    frame[at] ^= 0x20
    for decode in (zstd_decode, zstd_decode_python):
        with pytest.raises(ValueError, match="zstd"):
            decode(bytes(frame))


@needs_zstandard
def test_zstd_truncated_empty_garbage_and_dictionary_raise():
    frame = _compress(_data("text", 20_000, 2), 3, checksum=False)
    samples = [_data("text", 400, s) for s in range(200)]
    with_dict = zstandard.ZstdCompressor(dict_data=zstandard.train_dictionary(2048, samples)).compress(samples[0])
    for decode in (zstd_decode, zstd_decode_python):
        for bad, reason in ((frame[:-5], "truncated"), (b"", "empty"), (b"not zstd at all", "magic"), (with_dict, "dictionary")):
            with pytest.raises(ValueError, match=reason):
                decode(bad)


def test_zstd_failed_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    broken = tmp_path / "zstd_decoder.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(zstd, "SOURCE", broken)
    monkeypatch.setattr(zstd, "library_path", lambda: tmp_path / "libtfasr_zstd_broken.so")
    monkeypatch.setattr(zstd, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native zstd decoder failed"):
        zstd_decode(bytes.fromhex("28b52ffd") + bytes([0x20, 1, 0x09, 0, 0]) + b"a")


# ----------------------------------------------------------------------------
# (b)-(e): checkpoints that the JAX package writes

from tensorflowasr_tpu_torch import bridge  # noqa: E402
from tensorflowasr_tpu_torch.convert import orbax  # noqa: E402

WORKSPACE_DATA = """
data_config:
  train_dataset_config:
    enabled: true
    data_paths: [{{datadir}}/train.tsv]
    shuffle: false
    metadata: {{modeldir}}/metadata.json
    stage: train
  test_dataset_configs:
    - name: synthetic
      data_paths: [{{datadir}}/train.tsv]
      stage: test

learning_config:
  optimizer_config: {class_name: Adam, config: {learning_rate: 0.005}}
  batch_size: 1
  num_epochs: 1
"""
TEXTS = ("hello world", "speech test", "jax on tpu", "tiny data")


def _config_text(model_class: str = "tensorflow_asr.models.transducer.conformer>Conformer", blocks: int = 1) -> str:
    model = FIXTURE_CONFIG.split("\ndata_config:")[0]
    model = model.replace("tensorflow_asr.models.transducer.conformer>Conformer", model_class).replace("encoder_num_blocks: 1", f"encoder_num_blocks: {blocks}")
    return model + WORKSPACE_DATA


CTC_MODEL = """
model_config:
  class_name: tensorflow_asr.models.ctc.conformer>ConformerCtc
  config:
    name: conformer-ctc-tiny
    speech_config: {sample_rate: 16000, frame_ms: 25, stride_ms: 10, nfft: 512, num_feature_bins: 40, feature_type: log_mel_spectrogram}
    encoder_subsampling:
      class_name: tensorflow_asr.models.layers.subsampling>Conv2dSubsampling
      config: {filters: [8, 8], kernels: [3, 3], strides: [2, 2], paddings: [causal, causal], norms: [batch, batch], activations: [swish, swish]}
    encoder_dmodel: 32
    encoder_num_blocks: 1
    encoder_head_size: 8
    encoder_num_heads: 4
    encoder_mha_type: relmha
    encoder_kernel_size: 7
    encoder_ffm_scale_factor: 2
    encoder_dropout: 0.0
    blank: 0
"""


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def assert_same_tree(mine, ref) -> int:
    """Leaf by leaf and bit for bit: the same paths, containers, dtypes, shapes and bytes."""
    import jax

    assert jax.tree_util.tree_structure(mine, is_leaf=lambda x: isinstance(x, torch.Tensor)) == jax.tree_util.tree_structure(ref)
    got, want = dict(leaves(mine)), dict(leaves(ref))
    assert got.keys() == want.keys()
    for key, a in got.items():
        b = want[key]
        if isinstance(a, torch.Tensor):  # bf16
            b = np.asarray(b)
            assert a.dtype == torch.bfloat16 and str(b.dtype) == "bfloat16", key
            assert tuple(a.shape) == b.shape and np.array_equal(a.view(torch.int16).numpy(), b.view(np.int16)), key
        elif a is None or not hasattr(a, "dtype"):
            assert a == b and type(a) is type(b), key
        else:
            b = np.asarray(b)
            assert (a.dtype, a.shape) == (b.dtype, b.shape) and a.tobytes() == b.tobytes(), key
    return len(got)


def orbax_restore(path: str):
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(orbax.item_directory(path))


def _wav_corpus(datadir: str) -> None:
    from tensorflowasr_tpu_torch.data import audio

    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(TEXTS):
        n = 16000  # JAX's init and test then see the [1, 16000] shapes of its save's init: one cold compile of the model's ops
        sig = (0.3 * np.sin(2 * np.pi * (300 + 50 * i) * np.arange(n) / 16000) + 0.01 * rng.standard_normal(n)).astype(np.float32)
        path = os.path.join(datadir, f"{i}.wav")
        audio.write_wav(path, sig, 16000)
        rows.append(f"{path}\t{n / 16000.0}\t{text}")
    with open(os.path.join(datadir, "train.tsv"), "w") as f:
        f.write("PATH\tDURATION\tTRANSCRIPT\n" + "\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def jax_routes():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in XLA_ROUTES.items():
            mp.setenv(k, v)
        yield


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, jax_routes):
    """What the JAX package writes for the fixture's Conformer-T (1 block) and
    a Conformer-CTC of its encoder: ``train`` 2 steps (its
    CheckpointManager), ``save`` of the newest step, ``utils
    convert_checkpoint`` of a Keras h5 (where h5py is present), ``save`` of
    the CTC model's init; a bf16 tree with 0-d and empty leaves, and the
    saved variables again with ``use_ocdbt=False``."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from tensorflowasr_tpu.scripts import main as jmain

    root = str(tmp_path_factory.mktemp("orbax"))
    datadir, modeldir = os.path.join(root, "data"), os.path.join(root, "model")
    os.makedirs(datadir)
    os.makedirs(modeldir)
    _wav_corpus(datadir)
    config = os.path.join(root, "config.yml.j2")
    with open(config, "w") as f:
        f.write(_config_text())
    common = ["--config-path", config, "--datadir", datadir, "--modeldir", modeldir]
    out = {"root": root, "config": config, "datadir": datadir, "modeldir": modeldir, "common": common}
    assert jmain(["utils", "create_datasets_metadata", *common]) == 0
    assert jmain(["train", *common, "--epochs", "1", "--steps-per-epoch", "2", "--mxp", "none"]) == 0
    out["trainer"] = os.path.join(modeldir, "checkpoints")
    out["trainer_step"] = os.path.join(out["trainer"], "2")
    out["saved"] = os.path.join(root, "saved")
    assert jmain(["save", *common, "--output", out["saved"]]) == 0
    variables = orbax_restore(out["saved"])
    try:
        import h5py  # noqa: F401
    except ImportError:
        h5py = None
    if h5py is not None:
        from tests.test_torch_convert import _write_reference_h5

        h5 = os.path.join(root, "ref.weights.h5")
        _write_reference_h5(h5, variables, seed=3)
        out["converted"] = os.path.join(root, "converted")
        assert jmain(["utils", "convert_checkpoint", *common, "--h5", h5, "--output", out["converted"]]) == 0
    ctc_config = os.path.join(root, "ctc.yml.j2")
    with open(ctc_config, "w") as f:
        f.write(FIXTURE_CONFIG.split("\nmodel_config:")[0] + CTC_MODEL + WORKSPACE_DATA)
    out["ctc_config"] = ctc_config
    ctc_modeldir = os.path.join(root, "ctc_model")
    os.makedirs(ctc_modeldir)
    out["saved_ctc"] = os.path.join(root, "saved_ctc")
    assert jmain(["save", "--config-path", ctc_config, "--datadir", datadir, "--modeldir", ctc_modeldir, "--output", out["saved_ctc"]]) == 0
    tree = {"params": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), variables["params"]),
            "step": np.int32(7), "scale": np.float32(0.5), "flag": np.bool_(True), "counts": np.arange(3, dtype=np.int64),
            "opt": ({"mu": np.zeros((2, 3), np.float16)}, None, {}, []), "lr": 1e-3, "n": 3}
    out["bf16_tree"] = os.path.join(root, "bf16_tree")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(out["bf16_tree"], tree)
    out["no_ocdbt"] = os.path.join(root, "no_ocdbt")
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(out["no_ocdbt"], variables)
    return out


WRITTEN = ("trainer", "trainer_step", "saved", "converted", "saved_ctc", "bf16_tree", "no_ocdbt")


@pytest.mark.parametrize("name", WRITTEN)
def test_reader_equals_orbax_restore(artifacts, name):
    if name not in artifacts:
        pytest.skip("h5py is not installed: no convert_checkpoint artifact")
    assert assert_same_tree(orbax.read_checkpoint(artifacts[name]), orbax_restore(artifacts[name])) > 0


def test_reader_layouts_and_what_it_refuses(artifacts, tmp_path):
    import orbax.checkpoint as ocp

    assert orbax.item_directory(artifacts["trainer"]) == os.path.join(artifacts["trainer"], "2", "default")
    assert orbax.item_directory(artifacts["trainer_step"]) == os.path.join(artifacts["trainer"], "2", "default")
    assert orbax.item_directory(artifacts["saved"]) == artifacts["saved"]
    tree = orbax.read_checkpoint(artifacts["trainer"])
    assert sorted(tree) == ["batch_stats", "opt_state", "params", "rng", "step"] and int(tree["step"]) == 2
    assert isinstance(tree["opt_state"], list)  # optax's chain state is a sequence: rebuilt from the key types
    with pytest.raises(orbax.OrbaxFormatError, match="not an orbax checkpoint"):
        orbax.read_checkpoint(str(tmp_path))
    zarr3 = str(tmp_path / "zarr3")
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(zarr3, {"a": np.ones(3, np.float32)})
    with pytest.raises(orbax.OrbaxFormatError, match="zarr3"):
        orbax.read_checkpoint(zarr3)


def test_corrupt_node_and_dictionary_chunk_raise(artifacts, tmp_path):
    corrupt = str(tmp_path / "corrupt")
    shutil.copytree(artifacts["saved"], corrupt)
    node = os.path.join(corrupt, "manifest.ocdbt")
    data = bytearray(open(node, "rb").read())
    data[len(data) // 2] ^= 1
    open(node, "wb").write(bytes(data))
    with pytest.raises(orbax.OrbaxFormatError, match="CRC32C"):
        orbax.read_checkpoint(corrupt)
    if zstandard is None:
        return
    dictionary = str(tmp_path / "dictionary")
    shutil.copytree(artifacts["no_ocdbt"], dictionary)
    name = next(d for d in sorted(os.listdir(dictionary)) if d.startswith("params.") and os.path.isfile(os.path.join(dictionary, d, "0")))
    samples = [_data("text", 300, s) for s in range(200)]
    chunk = os.path.join(dictionary, name, "0")
    raw = zstd_decode(open(chunk, "rb").read())
    open(chunk, "wb").write(zstandard.ZstdCompressor(dict_data=zstandard.train_dictionary(1024, samples)).compress(raw))
    with pytest.raises(orbax.OrbaxFormatError, match="dictionary"):
        orbax.read_checkpoint(dictionary)


@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<f2", "bfloat16", "<i4", "<i8", "<u4", "|b1"])
def test_zarr_chunk_grid_fill_and_compressors_equal_tensorstore(tmp_path, dtype):
    """Arrays of several chunks (edge chunks cut, chunks never written taking
    ``fill_value``), zstd-coded and raw, read as tensorstore reads them."""
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(1)

    def get(key: str):
        path = tmp_path / key
        return path.read_bytes() if path.is_file() else None

    fill = True if dtype == "|b1" else 3 if dtype[1] in "iu" else 1.5
    for compressor in ({"id": "zstd", "level": 3}, None):
        name = f"x{'z' if compressor else 'raw'}"
        arr = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path / name}", "create": True,
                       "metadata": {"dtype": dtype, "shape": [5, 7], "chunks": [2, 3], "compressor": compressor, "fill_value": fill}}).result()
        values = np.asarray(rng.standard_normal((5, 7)) * 10).astype(arr.dtype.numpy_dtype)
        arr[0:4, 0:6] = values[0:4, 0:6]
        arr[4:5, 0:3] = values[4:5, 0:3]
        want = np.asarray(arr.read().result())
        got = orbax.read_zarr(get, name)
        if dtype == "bfloat16":
            assert got.dtype == torch.bfloat16 and np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)
        assert get(f"{name}/2.2") is None  # a chunk that was never written: its values are fill_value


def _port_args(**kw):
    import types

    return types.SimpleNamespace(**{"device": "cpu", "checkpoint": None, **kw})


@pytest.mark.parametrize("source", ["saved", "trainer", "no_ocdbt"])
def test_load_weights_strict_equals_bridge(artifacts, source):
    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.scripts import common

    config = pipeline.load_config(artifacts["config"], training=False, datadir=artifacts["datadir"], modeldir=artifacts["modeldir"])
    model = common.load_weights(common.build_model(config, pipeline.build_tokenizer(config), _port_args()), _port_args(checkpoint=artifacts[source]))
    restored = orbax_restore(artifacts[source])
    variables = {"params": restored["params"], "batch_stats": restored.get("batch_stats") or {}}
    want = bridge.state_dict_from_flax(variables)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def _tsv_rows(path: str) -> list:
    with open(path) as f:
        return [line.split("\t")[:3] for line in f.read().splitlines()]


@pytest.mark.parametrize("source", ["saved", "modeldir"])
def test_cli_test_equals_jax_test(artifacts, tmp_path, source):
    """``test`` on a JAX artifact: with ``--checkpoint`` the ``save``
    directory, and without it ``{{modeldir}}/checkpoints`` (the JAX Trainer's)."""
    from tensorflowasr_tpu.scripts import main as jmain
    from tensorflowasr_tpu.utils import app_util as japp_util
    from tensorflowasr_tpu_torch.scripts import main as pmain
    from tensorflowasr_tpu_torch.utils import app_util

    ckpt = ["--checkpoint", artifacts["saved"]] if source == "saved" else []
    jax_tsv, port_tsv = str(tmp_path / "jax.tsv"), str(tmp_path / "port.tsv")
    assert jmain(["test", *artifacts["common"], *ckpt, "--output", jax_tsv]) == 0
    assert pmain(["test", *artifacts["common"], *ckpt, "--output", port_tsv, "--device", "cpu"]) == 0
    assert _tsv_rows(port_tsv) == _tsv_rows(jax_tsv) and len(_tsv_rows(jax_tsv)) == 1 + len(TEXTS)
    assert app_util.evaluate_hypotheses(port_tsv) == japp_util.evaluate_hypotheses(jax_tsv)


def test_cli_save_and_export_take_a_jax_directory(artifacts, tmp_path):
    from tensorflowasr_tpu_torch import export, schemas
    from tensorflowasr_tpu_torch.models.transducer.base import recognize
    from tensorflowasr_tpu_torch.scripts import main as pmain

    args = [*artifacts["common"], "--checkpoint", artifacts["saved"], "--device", "cpu"]
    saved = str(tmp_path / "weights.pt")
    assert pmain(["save", *args, "--output", saved]) == 0
    want = orbax.load_state_dict(artifacts["saved"])
    got = torch.load(saved, weights_only=True)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    program = str(tmp_path / "model.pt2")
    assert pmain(["export", *args, "--output", program]) == 0
    signals, lengths = fixture_signals()
    sig, lens = torch.tensor(signals[:1]), torch.tensor(lengths[:1], dtype=torch.int32)
    out = export.load_program(program)(sig, lens)
    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.scripts import common

    config = pipeline.load_config(artifacts["config"], training=False)
    model = common.load_weights(common.build_model(config, pipeline.build_tokenizer(config), _port_args()), _port_args(checkpoint=artifacts["saved"]))
    eager = recognize(model, schemas.PredictInput(inputs=sig, inputs_length=lens.long()))
    assert torch.equal(out.tokens, eager.tokens)


def test_warm_start_from_a_jax_trainer_directory(artifacts, caplog):
    """JAX's Trainer directory (1 block) seeds a port model of 2 blocks: every
    shared tensor loads, equal to JAX's warm start of its own 2-block
    TrainState on those names; the second block keeps its initialisation."""
    import logging

    import jax

    from tensorflowasr_tpu import schemas as jschemas
    from tensorflowasr_tpu.models import build_model as jbuild_model
    from tensorflowasr_tpu.optimizers import build_optimizer as jbuild_optimizer
    from tensorflowasr_tpu.training import pretrained as jpretrained
    from tensorflowasr_tpu.training import trainer as jtrainer
    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.training.pretrained import warm_start
    from tensorflowasr_tpu_torch.training.trainer import Trainer

    config_path = os.path.join(artifacts["root"], "two_blocks.yml.j2")
    with open(config_path, "w") as f:
        f.write(_config_text(blocks=2))
    config = pipeline.load_config(config_path, training=False)
    tokenizer = pipeline.build_tokenizer(config)
    model = pipeline.build_model_from_config(config, tokenizer, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(5))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = {"class_name": "Adam", "config": {"learning_rate": 1e-3}}
    with caplog.at_level(logging.INFO, logger="tensorflowasr_tpu_torch"):
        state = warm_start(Trainer(model, optimizer, device="cpu").init_state(), artifacts["trainer"])
    got = state.model.state_dict()
    source = orbax.load_state_dict(artifacts["trainer"])
    shared = {k for k in got if k in source}
    assert shared and all("block_1" not in k for k in shared)
    assert f"{len(shared)} tensors loaded, {len(got) - len(shared)} kept from init" in caplog.text
    for k in got:
        assert torch.equal(got[k], source[k] if k in shared else init[k]), k

    jm = jbuild_model(config.model_config, vocab_size=tokenizer.num_classes)
    ti = jschemas.TrainInput(np.zeros((1, 16000), np.float32), np.asarray([16000], np.int32), np.zeros((1, 2), np.int32), np.asarray([2], np.int32))
    variables = jm.init({"params": jax.random.PRNGKey(1)}, ti, train=False)
    # JAX's _load_tree takes the newest step directory but not its default/ item, so it is given the item itself
    item = orbax.item_directory(artifacts["trainer"])
    jstate = jpretrained.warm_start(jtrainer.TrainState.create(variables, jbuild_optimizer(optimizer), jax.random.PRNGKey(0)), item)
    jgot = bridge.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.variables()))
    for k in shared:
        assert torch.equal(jgot[k], got[k]), k


def test_flagship_full_width_loads_strictly_and_equal(tmp_path, jax_routes, capsys):
    """The flagship's variables (JAX ``model.init`` at full width, about 41 MB
    of f32), saved as ``scripts/save.py`` saves them, load strictly into the
    port's flagship with every tensor equal; no forward pass."""
    import jax
    import orbax.checkpoint as ocp

    from tensorflowasr_tpu import schemas as jschemas
    from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
    from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_config

    cfg = conformer_small_config(vocab_size=1000)
    jm = JConformer.from_config(cfg)
    ti = jschemas.TrainInput(np.zeros((1, 1600), np.float32), np.asarray([1600], np.int32), np.zeros((1, 2), np.int32), np.asarray([2], np.int32))
    variables = jax.device_get(jm.init({"params": jax.random.PRNGKey(0)}, ti, train=False))
    path = str(tmp_path / "flagship")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, variables)
    decoded = {"bytes": 0, "s": 0.0}

    def counted(data: bytes) -> bytes:
        t = time.perf_counter()
        out = zstd_decode(data)
        decoded["s"] += time.perf_counter() - t
        decoded["bytes"] += len(out)
        return out

    orbax.zstd_decode = counted
    try:
        t = time.perf_counter()
        state_dict = orbax.load_state_dict(path)
        wall = time.perf_counter() - t
    finally:
        orbax.zstd_decode = zstd_decode
    nbytes = sum(v.numel() * 4 for v in state_dict.values())
    assert nbytes > 40e6
    with capsys.disabled():
        print(f"\nflagship variables: {nbytes / 1e6:.1f} MB of f32; native zstd {decoded['bytes'] / 1e6:.1f} MB out at "
              f"{decoded['bytes'] / decoded['s'] / 1e6:.0f} MB/s; the whole read {nbytes / wall / 1e6:.0f} MB/s (this CPU)")
    model = Conformer.from_config(cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    want = bridge.state_dict_from_flax(variables)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


# ----------------------------------------------------------------------------
# the committed fixture and the example scripts


def test_fixture_reads_as_orbax_reads_it(jax_routes):
    ckpt = os.path.join(FIXTURE, "checkpoint")
    assert assert_same_tree(orbax.read_checkpoint(FIXTURE), orbax_restore(ckpt)) > 0
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(FIXTURE) for f in files)
    assert total <= 256 * 1024, total


def test_fixture_port_reproduces_the_recorded_jax_outputs():
    from tensorflowasr_tpu_torch import pipeline, schemas
    from tensorflowasr_tpu_torch.models.transducer.base import recognize
    from tensorflowasr_tpu_torch.scripts import common

    config = pipeline.load_config(os.path.join(FIXTURE, "config.yml.j2"), training=False)
    model = common.load_weights(common.build_model(config, pipeline.build_tokenizer(config), _port_args()), _port_args(checkpoint=FIXTURE))
    expected = np.load(os.path.join(FIXTURE, "expected.npz"))
    pcm, lengths = fixture_batch()
    assert np.array_equal(expected["pcm"], pcm) and np.array_equal(expected["lengths"], lengths)
    signals, _ = fixture_signals()
    sig, lens = torch.tensor(signals), torch.tensor(lengths, dtype=torch.int64)
    with torch.inference_mode():
        enc, enc_len, _ = model.encode(sig, lens)
        out = recognize(model, schemas.PredictInput(inputs=sig, inputs_length=lens))
    scale = max(1.0, float(np.abs(expected["encoded"]).max()))
    assert np.abs(enc.numpy() - expected["encoded"]).max() <= 1e-4 * scale
    assert np.array_equal(enc_len.numpy(), expected["encoded_length"])
    assert np.array_equal(out.tokens.numpy(), expected["tokens"])


def _run_script(path: str, argv: list, capsys) -> str:
    import runpy

    capsys.readouterr()
    saved = sys.argv
    sys.argv = [path, *argv]
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved
    return capsys.readouterr().out


@pytest.mark.parametrize("script, extra", [("main.py", []), ("rnn_transducer.py", []), ("rnn_transducer.py", ["--chunk-secs", "0.4"])])
def test_examples_equal_the_jax_examples(jax_routes, tmp_path, capsys, script, extra):
    from tensorflowasr_tpu_torch.data import audio

    signals, lengths = fixture_signals()
    wav = str(tmp_path / "fixture.wav")
    audio.write_wav(wav, signals[0, : lengths[0]], 16000)
    args = ["--config-path", os.path.join(FIXTURE, "config.yml.j2"), "--audio", wav, *extra]
    jax_out = _run_script(os.path.join(REPO, "examples", "inferences", script), [*args, "--checkpoint", os.path.join(FIXTURE, "checkpoint")], capsys)
    port_out = _run_script(os.path.join(REPO, "tensorflowasr_tpu_torch", "examples", "inferences", script),
                           [*args, "--checkpoint", FIXTURE, "--device", "cpu"], capsys)
    assert port_out.strip() and port_out == jax_out


def test_program_examples_run_an_exported_program(tmp_path, capsys):
    from tensorflowasr_tpu_torch.data import audio
    from tensorflowasr_tpu_torch.scripts import main as pmain

    signals, lengths = fixture_signals()
    wav = str(tmp_path / "fixture.wav")
    audio.write_wav(wav, signals[0, : lengths[0]], 16000)
    common = ["--config-path", os.path.join(FIXTURE, "config.yml.j2"), "--checkpoint", FIXTURE, "--device", "cpu"]
    program, streaming = str(tmp_path / "m.pt2"), str(tmp_path / "s.pt2")
    assert pmain(["export", *common, "--output", program]) == 0
    assert pmain(["export", *common, "--output", streaming, "--streaming"]) == 0
    main_out = _run_script(os.path.join(REPO, "tensorflowasr_tpu_torch", "examples", "inferences", "main.py"),
                           ["--config-path", os.path.join(FIXTURE, "config.yml.j2"), "--audio", wav, "--checkpoint", FIXTURE, "--device", "cpu"], capsys)
    out = _run_script(os.path.join(REPO, "tensorflowasr_tpu_torch", "examples", "inferences", "program.py"),
                      ["--artifact", program, "--audio", wav, "--device", "cpu"], capsys)
    assert f"transcript: {main_out.strip()}" in out
    out = _run_script(os.path.join(REPO, "tensorflowasr_tpu_torch", "examples", "inferences", "streaming_program.py"),
                      [wav, "--program", streaming, "--device", "cpu"], capsys)
    assert out.splitlines()[-1] == main_out.strip()


if __name__ == "__main__" and "--write-fixture" in sys.argv:
    sys.path.insert(0, REPO)
    write_fixture()
    sys.exit(0)
