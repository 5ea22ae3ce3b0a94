"""The port's audio, TFRecord and dataset layers against the JAX package's, on the CPU.

Everything here is exact: audio bit for bit (WAV, FLAC through the native
and the pure-Python decoders, each package's files read by the other's
readers), TFRecord files and ``Example`` encodings byte for byte, dataset
metadata and every padded batch element for element. ``resample`` is
held to 1e-6 (both call scipy's polyphase filter).
"""

import gzip
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from tensorflowasr_tpu.configs import Config as JConfig
from tensorflowasr_tpu.configs import DecoderConfig as JDecoderConfig
from tensorflowasr_tpu.data import audio as jaudio
from tensorflowasr_tpu.data import datasets as jdatasets
from tensorflowasr_tpu.data import tfrecord as jtfrecord
from tensorflowasr_tpu.tokenizers import CharTokenizer as JCharTokenizer
from tensorflowasr_tpu_torch import native
from tensorflowasr_tpu_torch.configs import Config, DecoderConfig
from tensorflowasr_tpu_torch.data import audio, datasets, tfrecord
from tensorflowasr_tpu_torch.tokenizers import CharTokenizer
from tests.test_tokenizers import CORPUS

RATE = 16000


def _signal(rng, n: int, channels: int = 1) -> np.ndarray:
    t = np.arange(n) / RATE
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t) + 0.05 * rng.standard_normal(n)
    if channels > 1:
        x = np.stack([x, 0.5 * x + 0.02 * rng.standard_normal(n)], axis=1)
    return np.clip(x, -1, 1).astype(np.float32)


# --------------------------------- audio ---------------------------------- #


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_bit_equal_both_ways(tmp_path, channels):
    x = _signal(np.random.default_rng(channels), 5001, channels)
    assert audio.wav_bytes(x, RATE) == jaudio.wav_bytes(x, RATE)
    audio.write_wav(str(tmp_path / "port.wav"), x, RATE)
    jaudio.write_wav(str(tmp_path / "jax.wav"), x, RATE)
    for name in ("port.wav", "jax.wav"):
        (ours, r1), (theirs, r2) = audio.read_wav(str(tmp_path / name)), jaudio.read_wav(str(tmp_path / name))
        assert r1 == r2 == RATE and ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    assert audio.audio_duration(str(tmp_path / "port.wav")) == jaudio.audio_duration(str(tmp_path / "port.wav"))


@pytest.mark.parametrize("channels, bits, block", [(1, 16, 1024), (2, 16, 1152), (1, 24, 4096), (2, 24, 512)])
def test_flac_bit_equal_native_and_python_both_ways(tmp_path, channels, bits, block):
    """Several frames (the last one short), mono and stereo, 16 and 24 bits."""
    x = _signal(np.random.default_rng(bits + channels), 5 * block + 37, channels)
    audio.write_flac(str(tmp_path / "port.flac"), x, RATE, bits_per_sample=bits, block_size=block)
    jaudio.write_flac(str(tmp_path / "jax.flac"), x, RATE, bits_per_sample=bits, block_size=block)
    assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()
    for name in ("port.flac", "jax.flac"):
        path = str(tmp_path / name)
        ref, rate = jaudio.read_flac(path)
        assert rate == RATE and ref.shape == x.shape
        for got, got_rate in (audio.read_flac(path), audio.read_flac_python(path)):
            assert got_rate == RATE and got.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(audio.read_audio(path, RATE), jaudio.read_audio(path, RATE))
        assert audio.audio_duration(path) == jaudio.audio_duration(path)


def test_native_decoder_builds_into_the_build_directory():
    path = native.library_path()
    native.lib()
    assert path.exists() and path.parent.name == "_build" and path.parent.parent.name == "tensorflowasr_tpu_torch"


def test_native_decoder_raises_on_a_broken_stream(tmp_path):
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"RIFF" + b"\0" * 60)
    with pytest.raises(ValueError, match="FLAC"):
        audio.read_flac(str(bad))


@pytest.mark.parametrize("orig", [8000, 22050, 44100])
def test_resample_and_read_audio_equal_jax(tmp_path, orig):
    x = _signal(np.random.default_rng(orig), 4000, 2)
    np.testing.assert_allclose(audio.resample(x[:, 0], orig, RATE), jaudio.resample(x[:, 0], orig, RATE), rtol=0, atol=1e-6)
    audio.write_wav(str(tmp_path / "a.wav"), x, orig)
    audio.write_flac(str(tmp_path / "a.flac"), x, orig)
    for name in ("a.wav", "a.flac"):
        path = str(tmp_path / name)
        np.testing.assert_allclose(audio.read_audio(path, RATE), jaudio.read_audio(path, RATE), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(audio.read_audio(path, None, mono=False), jaudio.read_audio(path, None, mono=False))


# -------------------------------- tfrecord -------------------------------- #

FEATURES = {"path": "/data/a.flac", "audio": bytes(range(256)) * 3, "transcript": "hello world", "ids": [1, 2, 300, -5, 2**40],
            "floats": np.asarray([0.5, -1.25, 3e-8], np.float32), "arr": np.arange(7, dtype=np.int64)}


def test_example_encoding_byte_equal_and_round_trips():
    data = tfrecord.encode_example(FEATURES)
    assert data == jtfrecord.encode_example(FEATURES)
    ours, theirs = tfrecord.decode_example(data), jtfrecord.decode_example(data)
    assert set(ours) == set(theirs) == set(FEATURES)
    for k in FEATURES:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert ours["transcript"] == b"hello world" and list(ours["ids"]) == FEATURES["ids"]
    assert tfrecord.crc32c(data) == jtfrecord.crc32c(data) and tfrecord.masked_crc(data) == jtfrecord.masked_crc(data)


@pytest.mark.parametrize("compression", [None, "GZIP"])
def test_tfrecord_files_byte_equal_both_ways(tmp_path, monkeypatch, compression):
    monkeypatch.setattr(gzip.time, "time", lambda: 1.7e9)  # the GZIP header's mtime
    records = [tfrecord.encode_example({**FEATURES, "i": [i]}) for i in range(5)] + [b"", b"x" * 70000]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert tfrecord.write_records(str(tmp_path / "port" / "r.tfrecord"), iter(records), compression=compression) == len(records)
    jtfrecord.write_records(str(tmp_path / "jax" / "r.tfrecord"), iter(records), compression=compression)
    assert (tmp_path / "port" / "r.tfrecord").read_bytes() == (tmp_path / "jax" / "r.tfrecord").read_bytes()
    for side in ("port", "jax"):
        path = str(tmp_path / side / "r.tfrecord")
        assert list(tfrecord.read_records(path, compression=compression, verify=True)) == records
        assert list(jtfrecord.read_records(path, compression=compression, verify=True)) == records


# -------------------------------- datasets -------------------------------- #

N_UTTS = 7


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A manifest of mixed WAV and FLAC files (one stereo, one at 8 kHz) with
    CORPUS transcripts, and the char tokenizer on both sides."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(7)
    rows = []
    texts = sorted(set(CORPUS)) + ["it's a test", "one more"]
    for i in range(N_UTTS):
        n = int(rng.integers(2000, 9000))
        rate = 8000 if i == 3 else RATE
        x = _signal(rng, n, 2 if i == 5 else 1)
        path = str(root / f"u{i}.{'flac' if i % 2 else 'wav'}")
        (audio.write_flac if i % 2 else audio.write_wav)(path, x, rate)
        rows.append(f"{path}\t{audio.audio_duration(path)}\t{texts[i].upper() if i == 2 else texts[i]}")
    manifest = root / "transcripts.tsv"
    manifest.write_text("PATH\tDURATION\tTRANSCRIPT\n" + "\n".join(rows) + "\n\n")
    tok, jtok = CharTokenizer(DecoderConfig({"type": "characters"})), JCharTokenizer(JDecoderConfig({"type": "characters"}))
    tok.make()
    jtok.make()
    return root, str(manifest), tok, jtok


def _pair(corpus, **kw):
    root, manifest, tok, jtok = corpus
    return datasets.ASRSliceDataset(tok, data_paths=[manifest], **kw), jdatasets.ASRSliceDataset(jtok, data_paths=[manifest], **kw)


def _same_batch(got, ref):
    pairs = [(got.inputs.inputs, ref.inputs.inputs), (got.inputs.inputs_length, ref.inputs.inputs_length),
             (got.inputs.predictions, ref.inputs.predictions), (got.inputs.predictions_length, ref.inputs.predictions_length),
             (got.labels.labels, ref.labels.labels), (got.labels.labels_length, ref.labels.labels_length)]
    for g, r in pairs:
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.dtype == (torch.float32 if r.dtype == np.float32 else torch.int64)
        np.testing.assert_array_equal(g.numpy(), r)


def test_metadata_equal_jax(corpus, tmp_path):
    ours, theirs = _pair(corpus, stage="train")
    assert ours.compute_metadata() == theirs.compute_metadata()
    assert ours.entries == theirs.entries and ours.num_entries == N_UTTS
    ours.save_metadata(str(tmp_path / "ours.json"))
    theirs.save_metadata(str(tmp_path / "theirs.json"))
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "theirs.json").read_text()
    for stage in ("train", "eval"):  # a second stage merges into the same file
        a, b = _pair(corpus, stage=stage, metadata=str(tmp_path / "both.json"))
        a.update_metadata()
        b.update_metadata(str(tmp_path / "both_jax.json"))
    assert json.loads((tmp_path / "both.json").read_text()) == json.loads((tmp_path / "both_jax.json").read_text())
    loaded, jloaded = _pair(corpus, stage="eval", metadata=str(tmp_path / "both.json"))
    assert (loaded.max_input_length, loaded.max_label_length, loaded.num_entries) == (jloaded.max_input_length, jloaded.max_label_length,
                                                                                      jloaded.num_entries)


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("padded", [True, False])
def test_every_batch_equals_jax(corpus, drop_remainder, num_workers, padded):
    ours, theirs = _pair(corpus, stage="eval", indefinite=False, drop_remainder=drop_remainder)
    if padded:
        ours.compute_metadata()
        theirs.compute_metadata()
    got = list(ours.create(3, num_workers=num_workers))
    ref = list(theirs.create(3, num_workers=num_workers))
    assert len(got) == len(ref) == (N_UTTS // 3 if drop_remainder else -(-N_UTTS // 3))
    for g, r in zip(got, ref):
        _same_batch(g, r)
    if padded:
        assert got[0].inputs.inputs.shape[1] == ours.max_input_length


def test_indefinite_create_repeats_and_closing_stops_its_thread(corpus):
    ours, theirs = _pair(corpus, stage="train")
    prefetchers = lambda: {t for t in threading.enumerate() if t.name == "tfasr-prefetch"}
    before = prefetchers()
    it, jit = ours.create(2, num_workers=2, prefetch=2), theirs.create(2, num_workers=2)
    for _ in range(2 * N_UTTS):  # four passes over the manifest
        _same_batch(next(it), next(jit))
    assert prefetchers() - before
    it.close()
    deadline = time.time() + 30
    while prefetchers() - before and time.time() < deadline:
        time.sleep(0.05)
    assert not prefetchers() - before


def test_a_decode_error_is_raised_by_create(corpus, tmp_path):
    root, manifest, tok, _ = corpus
    bad = tmp_path / "bad.tsv"
    bad.write_text(open(manifest).read() + f"{tmp_path / 'missing.wav'}\t1.0\tgone\n")
    ds = datasets.ASRSliceDataset(tok, data_paths=[str(bad)], indefinite=False)
    with pytest.raises(FileNotFoundError):
        list(ds.create(4, num_workers=2))


def test_decode_threads_under_stress_keep_order_and_values(corpus):
    """More decode threads than cores, with the interpreter switching threads
    every microsecond: every example equals the single-threaded pass, in
    manifest order (the native decoder's first load is locked; decoding
    shares no state)."""
    import sys

    ours, _ = _pair(corpus, stage="eval", indefinite=False)
    want = list(ours.examples(num_workers=0))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.time()
        for _ in range(3):
            got = list(ours.examples(num_workers=4 * (os.cpu_count() or 4)))
            assert [e["path"] for e in got] == [e["path"] for e in want]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["inputs"], w["inputs"])
                np.testing.assert_array_equal(g["labels"], w["labels"])
        assert time.time() - t0 < 120
    finally:
        sys.setswitchinterval(interval)


def test_labelled_batches_carry_their_entries(corpus):
    ours, _ = _pair(corpus, stage="eval", indefinite=False, drop_remainder=False)
    ours.read_entries()
    seen = [entry for _, entries in ours.labelled_batches(3, num_workers=2) for entry in entries]
    assert seen == [(path, transcript) for path, _, transcript in ours.entries]


@pytest.mark.parametrize("dataset_type", ["slice", "tfrecord"])
def test_rank_and_world_cover_every_entry_once(corpus, tmp_path, dataset_type):
    root, manifest, tok, _ = corpus
    kw = {"tfrecords_dir": str(tmp_path / "tfr"), "tfrecords_shards": 4} if dataset_type == "tfrecord" else {}
    if dataset_type == "tfrecord":
        datasets.ASRTFRecordDataset(tok, stage="test", data_paths=[manifest], **kw).create_tfrecords()
    seen = []
    for rank in range(3):
        cls = datasets.ASRTFRecordDataset if dataset_type == "tfrecord" else datasets.ASRSliceDataset
        ds = cls(tok, stage="test", data_paths=[manifest], indefinite=False, rank=rank, world=3, **kw)
        seen += [ex["path"] for ex in ds.examples(num_workers=2)]
    assert sorted(seen) == sorted(line.split("\t")[0] for line in open(manifest).read().splitlines()[1:] if line)
    with pytest.raises(ValueError, match="rank"):
        datasets.ASRSliceDataset(tok, data_paths=[manifest], rank=3, world=3)


def test_tfrecord_dataset_round_trips_and_reads_like_jax(corpus, tmp_path):
    """The port writes shards, both packages read them to the same batches,
    and they equal the audio files' batches: exactly for the mono 16 kHz
    files (PCM16 in, PCM16 out, samples below 0.5), within 1.5 PCM16 steps
    for the stereo and 8 kHz ones (the mono mean and the resampled signal
    are stored as PCM16: half a step of rounding, and the codec writes
    round(x·32767) and reads v / 32768)."""
    root, manifest, tok, jtok = corpus
    kw = {"stage": "eval", "data_paths": [manifest], "tfrecords_dir": str(tmp_path / "tfr"), "tfrecords_shards": 1, "indefinite": False,
          "drop_remainder": False}
    ours = datasets.ASRTFRecordDataset(tok, **kw)
    assert ours.create_tfrecords()
    theirs = jdatasets.ASRTFRecordDataset(jtok, **kw)
    files = datasets.ASRSliceDataset(tok, **{k: v for k, v in kw.items() if not k.startswith("tfrecords")})
    ex = list(ours.examples())
    assert [e["path"] for e in ex] == [line.split("\t")[0] for line in open(manifest).read().splitlines()[1:] if line]
    row = 0
    for g, r, f in zip(ours.create(4, num_workers=0), theirs.create(4, num_workers=0), files.create(4, num_workers=0)):
        _same_batch(g, r)
        np.testing.assert_array_equal(g.labels.labels.numpy(), f.labels.labels.numpy())
        np.testing.assert_array_equal(g.inputs.inputs_length.numpy(), f.inputs.inputs_length.numpy())
        for got, want in zip(g.inputs.inputs.numpy(), f.inputs.inputs.numpy()):
            np.testing.assert_allclose(got, want, rtol=0, atol=0 if row not in (3, 5) else 1.5 / 32767, err_msg=f"row {row}")
            row += 1
    assert row == N_UTTS
    jdir = tmp_path / "jtfr"
    jwriter = jdatasets.ASRTFRecordDataset(jtok, **{**kw, "tfrecords_dir": str(jdir)})
    jwriter.create_tfrecords()
    assert (jdir / "eval_00.tfrecord").exists()
    reread = datasets.ASRTFRecordDataset(tok, **{**kw, "tfrecords_dir": str(jdir)})
    for g, r in zip(reread.create(4, num_workers=0), theirs.create(4, num_workers=0)):
        _same_batch(g, r)


def test_get_global_shape_equals_jax(corpus, tmp_path):
    cfg = {"learning_config": {"batch_size": 3}}
    ours, theirs = _pair(corpus, stage="train")
    ours.compute_metadata()
    theirs.compute_metadata()
    for kw in ({}, {"batch_size": 5}, {"num_devices": 4, "num_local_devices": 2}):
        assert datasets.get_global_shape(Config(cfg), ours, **kw) == jdatasets.get_global_shape(JConfig(cfg), theirs, **kw)
    assert datasets.get_global_shape(Config(cfg))["padded_input_length"] is None
