"""The port's command line end to end on the CPU (``--device cpu``): the
cases of ``tests/test_cli_e2e.py`` on its DeepSpeech2-tiny config and
synthetic corpus.

- ``utils create_datasets_metadata``, then ``train`` for 3 steps writes a
  checkpoint under ``{{modeldir}}/checkpoints``; ``train --profile`` writes
  a ``torch.profiler`` trace of 5 steps after a warm-up step;
- ``test`` restores it and writes a TSV of a header and 4 rows;
- ``save`` writes the inference ``state_dict`` and reloads it (equal to the
  checkpoint's weights);
- ``export`` writes a ``.pt2`` that ``load_program`` runs in a fresh
  process, tokens equal to eager ``recognize`` on the same weights;
  ``--streaming`` adds the carried states to the signature; ``--format
  tflite`` reports failure (no TensorFlow);
- ``utils create_mls_trans`` and the TFRecord pipeline (``utils
  create_tfrecords --dataset-type tfrecord``, then batches from the shards);
- ``python -m tensorflowasr_tpu_torch --help`` lists the subcommands, and a
  subcommand that builds a model raises without a card unless ``--device
  cpu`` is given.
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch.data import audio
from tensorflowasr_tpu_torch.scripts import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = """
decoder_config:
  type: characters
  blank_index: 0

model_config:
  class_name: tensorflow_asr.models.ctc.deepspeech2>DeepSpeech2
  config:
    name: ds2-tiny
    speech_config:
      sample_rate: 16000
      frame_ms: 25
      stride_ms: 10
      num_feature_bins: 40
      nfft: 512
      feature_type: log_mel_spectrogram
    conv_type: conv2d
    conv_kernels: [[3, 5]]
    conv_strides: [[2, 2]]
    conv_filters: [4]
    rnn_nlayers: 1
    rnn_type: lstm
    rnn_units: 16
    rnn_bidirectional: True
    fc_nlayers: 0
    blank: 0

data_config:
  train_dataset_config:
    enabled: true
    data_paths:
      - {{datadir}}/train.tsv
    shuffle: true
    metadata: {{modeldir}}/metadata.json
    tfrecords_dir: {{datadir}}/tfrecords
    tfrecords_shards: 2
    stage: train
  test_dataset_configs:
    - name: synthetic
      data_paths:
        - {{datadir}}/train.tsv
      stage: test

learning_config:
  optimizer_config:
    class_name: Adam
    config:
      learning_rate: 0.005
  batch_size: 2
  num_epochs: 1
  callbacks:
    - class_name: tensorflow_asr.callbacks>TerminateOnNaN
      config: {}
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    datadir, modeldir = root / "data", root / "model"
    datadir.mkdir()
    modeldir.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(["hello world", "speech test", "jax on tpu", "tiny data"]):
        n = 3200
        sig = (0.3 * np.sin(2 * np.pi * (300 + 50 * i) * np.arange(n) / 16000) + 0.01 * rng.standard_normal(n)).astype(np.float32)
        path = datadir / f"{i}.wav"
        audio.write_wav(str(path), sig, 16000)
        rows.append(f"{path}\t{n / 16000.0}\t{text}")
    (datadir / "train.tsv").write_text("PATH\tDURATION\tTRANSCRIPT\n" + "\n".join(rows) + "\n")
    config = root / "config.yml.j2"
    config.write_text(CONFIG)
    ws = {"config": str(config), "datadir": str(datadir), "modeldir": str(modeldir)}
    ws["common"] = ["--config-path", ws["config"], "--datadir", ws["datadir"], "--modeldir", ws["modeldir"], "--device", "cpu"]
    assert main(["utils", "create_datasets_metadata", *ws["common"]]) == 0
    assert main(["train", *ws["common"], "--epochs", "1", "--steps-per-epoch", "3", "--mxp", "none"]) == 0
    return ws


def _checkpoint_weights(workspace):
    from tensorflowasr_tpu_torch.training import pretrained

    return pretrained.load_state_dict(os.path.join(workspace["modeldir"], "checkpoints"))


def test_cli_train(workspace):
    ckpt_dir = os.path.join(workspace["modeldir"], "checkpoints")
    assert os.listdir(ckpt_dir) == ["3"]
    assert os.path.exists(os.path.join(workspace["modeldir"], "metadata.json"))
    state = torch.load(os.path.join(ckpt_dir, "3", "state.pt"), weights_only=True)
    assert state["step"] == 3 and all(torch.isfinite(v).all() for v in state["model"].values())


def test_cli_train_profile(workspace, tmp_path):
    modeldir, trace = tmp_path / "model", tmp_path / "trace"
    common = [*workspace["common"][:4], "--modeldir", str(modeldir), "--device", "cpu"]
    assert main(["train", *common, "--epochs", "1", "--steps-per-epoch", "1", "--mxp", "none", "--profile", str(trace)]) == 0
    assert os.listdir(trace) == ["train_steps.trace.json"] and os.path.getsize(trace / "train_steps.trace.json") > 0
    assert os.listdir(modeldir / "checkpoints") == ["7"]  # 1 warm-up and 5 profiled steps, then the epoch's 1
    names = collections.Counter(e.get("name") for e in json.load(open(trace / "train_steps.trace.json"))["traceEvents"])
    assert all(names[f"train.{p}"] == 5 for p in ("step", "zero_grad", "forward", "loss", "backward", "update")), names  # the program's spans


def test_cli_test(workspace):
    out = os.path.join(workspace["modeldir"], "predictions.tsv")
    assert main(["test", *workspace["common"], "--bs", "2", "--beam-width", "2", "--output", out]) == 0
    lines = open(out).read().splitlines()
    assert lines[0] == "PATH\tGROUNDTRUTH\tGREEDY\tBEAMSEARCH"
    assert len(lines) == 5  # header + 4 utterances
    assert sorted(line.split("\t")[1] for line in lines[1:]) == sorted(["hello world", "speech test", "jax on tpu", "tiny data"])


def test_cli_save(workspace, tmp_path):
    out = tmp_path / "final" / "weights.pt"
    assert main(["save", *workspace["common"], "--output", str(out)]) == 0
    saved, ckpt = torch.load(out, weights_only=True), _checkpoint_weights(workspace)
    assert set(saved) == set(ckpt) and all(torch.equal(saved[k], v) for k, v in ckpt.items())


def test_cli_export_then_load_in_a_fresh_process(workspace, tmp_path):
    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.models.ctc.base import recognize
    from tensorflowasr_tpu_torch.schemas import PredictInput

    out = str(tmp_path / "model.pt2")
    assert main(["export", *workspace["common"], "--output", out]) == 0
    assert os.path.getsize(out) > 1000
    config = pipeline.load_config(workspace["config"], training=False, datadir=workspace["datadir"], modeldir=workspace["modeldir"])
    model = pipeline.build_model_from_config(config, pipeline.build_tokenizer(config), device="cpu")
    model.load_state_dict(_checkpoint_weights(workspace))
    sig = (np.random.default_rng(1).standard_normal((1, 16000)) * 0.3).astype(np.float32)
    io = str(tmp_path / "io.npz")
    np.savez(io, sig=sig, tokens=recognize(model.eval(), PredictInput(torch.tensor(sig), torch.tensor([16000], dtype=torch.int32))).tokens.numpy())
    script = ("import sys, numpy as np, torch\n"
              "from tensorflowasr_tpu_torch import export\n"
              f"f = export.load_program({out!r})\n"
              f"io = np.load({io!r})\n"
              "out = f(torch.tensor(io['sig']), torch.tensor([16000], dtype=torch.int32))\n"
              "assert np.array_equal(out.tokens.numpy(), io['tokens']), (out.tokens, io['tokens'])\n"
              "assert out.transcript.shape[:2] == out.tokens.shape\n"
              "print('ok', export.codepoints_to_text(out.transcript[0]))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), proc.stderr[-3000:]


def test_cli_export_streaming_signature(workspace, tmp_path):
    from tensorflowasr_tpu_torch import export

    out = str(tmp_path / "model_streaming.pt2")
    assert main(["export", *workspace["common"], "--output", out, "--streaming"]) == 0
    assert len(torch.export.load(out).graph_signature.user_inputs) == 5  # signals, lengths, previous tokens, encoder and decoder states (None here)
    fn = export.load_program(out)
    res = fn(torch.zeros((1, 16000)), torch.tensor([16000], dtype=torch.int32), torch.zeros((1,), dtype=torch.int64), None, None)
    assert res.tokens.shape[0] == 1 and res.next_tokens.shape == (1,)


def test_cli_tflite_reports_no_tensorflow(workspace, tmp_path):
    assert main(["tflite", *workspace["common"], "--output", str(tmp_path / "m.tflite"), "--format", "tflite"]) == 1


def test_cli_mls_trans(tmp_path):
    from tensorflowasr_tpu_torch.scripts.utils.create_mls_trans import convert_split

    split = tmp_path / "train"
    (split / "audio" / "1001" / "22").mkdir(parents=True)
    audio.write_flac(str(split / "audio" / "1001" / "22" / "1001_22_000000.flac"), np.zeros(1600, np.float32), 16000)
    (split / "transcripts.txt").write_text("1001_22_000000\thello mls\n")
    assert main(["utils", "create_mls_trans", "--split-dir", str(split)]) == 0
    lines = open(convert_split(str(split))).read().splitlines()
    assert lines[0] == "PATH\tDURATION\tTRANSCRIPT"
    assert lines[1].endswith("hello mls") and "0.100" in lines[1]


def test_cli_tfrecord_pipeline(workspace):
    from tensorflowasr_tpu_torch import pipeline

    assert main(["utils", "create_tfrecords", *workspace["common"], "--dataset-type", "tfrecord"]) == 0
    shards = sorted(os.listdir(os.path.join(workspace["datadir"], "tfrecords")))
    assert shards == ["train_00.tfrecord", "train_01.tfrecord"]
    config = pipeline.load_config(workspace["config"], datadir=workspace["datadir"], modeldir=workspace["modeldir"])
    ds = pipeline.build_datasets(config, pipeline.build_tokenizer(config), "tfrecord", stages=("train",))["train"]
    it = ds.create(2, prefetch=0)
    b, b2 = next(it), next(it)
    assert b.inputs.inputs.shape[0] == 2 and b2.inputs.inputs.shape == b.inputs.inputs.shape


def test_cli_help_and_device():
    proc = subprocess.run([sys.executable, "-m", "tensorflowasr_tpu_torch", "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    for name in ("train", "test", "save", "export", "tflite", "utils"):
        assert name in proc.stdout
    if not torch.cuda.is_available():
        for argv in (["train"], ["test"], ["save", "--output", "x.pt"], ["export", "--output", "x.pt2"]):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                main([*argv, "--config-path", os.devnull])
