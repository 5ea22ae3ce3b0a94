"""Learning, not parity: tiny port models overfit two utterances to WER 0
through the whole data path on the CPU (counterpart of ``tests/test_overfit.py``).

Audio files (one WAV, one FLAC) and a manifest → the char tokenizer with
the bundled vocabulary → ``ASRSliceDataset.create`` → ``Trainer.fit``
(Adam 3e-3, f32, dropout 0) in rounds of 20 steps → ``evaluate_dataset``
after each round, until it reads WER 0, within a cap of 400 steps.
JAX's test takes DeepSpeech2 for CTC; this one takes Conformer-CTC, and
``chip_smoke.py`` fits a 2-layer bidirectional DeepSpeech2 on the card.
"""

import gc
import os

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch.configs import DecoderConfig
from tensorflowasr_tpu_torch.data import audio, datasets
from tensorflowasr_tpu_torch.models import build_model
from tensorflowasr_tpu_torch.tokenizers import CharTokenizer
from tensorflowasr_tpu_torch.training.evaluation import evaluate_dataset
from tensorflowasr_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["ab cd", "ef gh"]
ROUND, CAP = 20, 400
_ENCODER = {
    "speech_config": {"num_feature_bins": 40, "nfft": 512},
    "encoder_subsampling": {"class_name": "Conv2dSubsampling", "config": {"filters": [16, 16], "kernels": [3, 3], "strides": [2, 2],
                                                                          "paddings": ["causal", "causal"], "norms": ["batch", "batch"],
                                                                          "activations": ["swish", "swish"]}},
    "encoder_dmodel": 32, "encoder_num_blocks": 1, "encoder_head_size": 8, "encoder_num_heads": 4, "encoder_kernel_size": 7, "encoder_dropout": 0.0,
}
MODELS = {
    "conformer_t": {"class_name": "tensorflow_asr.models.transducer.conformer>Conformer",
                    "config": {**_ENCODER, "prediction_embed_dim": 16, "prediction_num_rnns": 1, "prediction_rnn_units": 32, "joint_dim": 32}},
    "conformer_ctc": {"class_name": "tensorflow_asr.models.ctc.conformer>Conformer", "config": _ENCODER},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two 0.4 s tones with a little noise, as ``tests/test_overfit.py`` makes them, written as WAV and FLAC."""
    root = tmp_path_factory.mktemp("overfit")
    rows = []
    for i, text in enumerate(TEXTS):
        n = 6400
        x = 0.4 * np.sin(2 * np.pi * (200 + 80 * i) * np.arange(n) / 16000) + 0.01 * np.random.default_rng(i).standard_normal(n)
        path = str(root / f"u{i}.{'flac' if i else 'wav'}")
        (audio.write_flac if i else audio.write_wav)(path, x.astype(np.float32), 16000)
        rows.append(f"{path}\t{n / 16000}\t{text}")
    manifest = root / "transcripts.tsv"
    manifest.write_text("PATH\tDURATION\tTRANSCRIPT\n" + "\n".join(rows) + "\n")
    tok = CharTokenizer(DecoderConfig({"type": "characters", "vocabulary": os.path.join(REPO, "examples", "datasets", "librispeech", "characters",
                                                                                         "english.vocab")}))
    tok.make()
    return str(manifest), tok


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tiny_model_overfits_two_utterances_to_wer_0(corpus, name):
    manifest, tok = corpus
    model = build_model(MODELS[name], vocab_size=tok.num_classes, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    train = datasets.ASRSliceDataset(tok, stage="train", data_paths=[manifest])
    train.compute_metadata()
    test = datasets.ASRSliceDataset(tok, stage="test", data_paths=[manifest])
    test.compute_metadata()
    trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": 3e-3}}, device="cpu")
    state = trainer.init_state(seed=0)
    batches = train.create(2, num_workers=0)
    try:
        while True:
            state = trainer.fit(state, batches, epochs=1, steps_per_epoch=ROUND)
            report = evaluate_dataset(model, test, tok, batch_size=2, collect_rows=True, num_workers=0)
            if report["greedy"]["wer"] == 0.0 or state.step >= CAP:
                break
    finally:
        batches.close()
        gc.unfreeze()
    assert report["greedy"] == {"wer": 0.0, "cer": 0.0}, (state.step, report)
    assert [row[2] for row in report["rows"]] == TEXTS
