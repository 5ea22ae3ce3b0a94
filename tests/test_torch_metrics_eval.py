"""The port's metrics, edit distance and dataset evaluation against the JAX
package's, and the data-fed training step, on the CPU.

- ``wer``, ``cer``, ``ErrorRateAccumulator`` (MER, WIL, WIP) and
  ``evaluate_hypotheses`` equal JAX's exactly on random texts;
  ``edit_distance`` and ``wer_on_device`` equal JAX's and a brute force
  exactly on random int batches, zero lengths among them.
- The slice as a whole, on a four-utterance manifest of WAV and FLAC files
  with the char tokenizer, tiny 1-block Conformer-T and Conformer-CTC
  (f32, dropout 0) with JAX's weights carried by ``bridge.py``:
  ``evaluate_dataset`` gives JAX's rows (path, truth, greedy, beam) and WER
  and CER exactly, greedy and with beam search at W 4; two steps of
  ``Trainer.fit`` fed by the port's dataset
  match two JAX ``train_step``s fed by JAX's dataset within the step-parity
  tolerance of ``test_torch_train_slice.py`` (loss to 1e-5 relative, each
  gradient to 1e-4 of its tensor's scale plus 1e-6 of the largest), both
  with the ``xla`` loss.
- The config pipeline (``pipeline.py``) from ``char.yml.j2`` to datasets,
  and the import rules: the data, tokenizer and evaluation modules import
  without HF ``tokenizers`` and PyYAML, and no module of the port and
  nothing in ``chip_smoke.py`` imports JAX, TensorFlow, orbax or the JAX package.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowasr_tpu.configs import DecoderConfig as JDecoderConfig
from tensorflowasr_tpu.data import datasets as jdatasets
from tensorflowasr_tpu.models.ctc.conformer import ConformerCtc as JConformerCtc
from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu.ops import edit_distance as jedit
from tensorflowasr_tpu.optimizers import build_optimizer as jbuild_optimizer
from tensorflowasr_tpu.tokenizers import CharTokenizer as JCharTokenizer
from tensorflowasr_tpu.training import evaluation as jevaluation
from tensorflowasr_tpu.training import metrics as jmetrics
from tensorflowasr_tpu.training import trainer as jtrainer
from tensorflowasr_tpu_torch import bridge, pipeline
from tensorflowasr_tpu_torch.configs import DecoderConfig
from tensorflowasr_tpu_torch.data import audio, datasets
from tensorflowasr_tpu_torch.models.ctc.conformer import ConformerCtc
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tensorflowasr_tpu_torch.ops.edit_distance import edit_distance, wer_on_device
from tensorflowasr_tpu_torch.optimizers import build_optimizer
from tensorflowasr_tpu_torch.tokenizers import CharTokenizer
from tensorflowasr_tpu_torch.training import callbacks, metrics
from tensorflowasr_tpu_torch.training.evaluation import evaluate_dataset
from tensorflowasr_tpu_torch.training.trainer import Trainer
from tests.test_torch_ctc_slice import CONFORMER_CFG
from tests.test_torch_slice import TINY_CFG
from tests.test_torch_train_slice import ADAM, FROZEN, _close_scaled, _record_grads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["a", "b", "ab", "ba", "cat", "dog", "the", "'s", "x"]


def _texts(rng, n: int) -> list[str]:
    return [" ".join(rng.choice(WORDS, rng.integers(0, 7))) for _ in range(n)]


# -------------------------------- metrics --------------------------------- #


@pytest.mark.parametrize("seed", range(3))
def test_error_rates_equal_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    refs, hyps = _texts(rng, 40), _texts(rng, 40)
    hyps[:5] = refs[:5]  # some exact hits
    assert metrics.wer(refs, hyps) == jmetrics.wer(refs, hyps)
    assert metrics.cer(refs, hyps) == jmetrics.cer(refs, hyps)
    assert metrics.evaluate_hypotheses(list(zip(refs, hyps))) == jmetrics.evaluate_hypotheses(list(zip(refs, hyps)))
    ours, theirs = metrics.ErrorRateAccumulator(), jmetrics.ErrorRateAccumulator()
    for r, h in zip(refs, hyps):
        ours.update(r.split(), h.split())
        theirs.update(r.split(), h.split())
        assert metrics._align_counts(list(r), list(h)) == jmetrics._align_counts(list(r), list(h))
    assert (ours.hits, ours.substitutions, ours.deletions, ours.insertions) == (theirs.hits, theirs.substitutions, theirs.deletions, theirs.insertions)
    assert (ours.error_rate, ours.mer, ours.wip, ours.wil) == (theirs.error_rate, theirs.mer, theirs.wip, theirs.wil)
    assert metrics.wer([""], [""]) == 0.0 and metrics.ErrorRateAccumulator().wip == 0.0


def _brute(a, b) -> int:
    prev = list(range(len(a) + 1))
    for i, y in enumerate(b):
        cur = [i + 1]
        for j, x in enumerate(a):
            cur.append(min(prev[j + 1] + 1, cur[-1] + 1, prev[j] + (x != y)))
        prev = cur
    return prev[-1]


@pytest.mark.parametrize("seed, shape", [(0, (16, 8, 9)), (1, (7, 1, 12)), (2, (5, 20, 3)), (3, (4, 6, 1))])
def test_edit_distance_equals_jax_and_brute_force(seed, shape):
    b, u, v = shape
    rng = np.random.default_rng(seed)
    refs, hyps = rng.integers(1, 5, (b, u)).astype(np.int32), rng.integers(1, 5, (b, v)).astype(np.int32)
    rl, hl = rng.integers(0, u + 1, b).astype(np.int32), rng.integers(0, v + 1, b).astype(np.int32)
    rl[0], hl[1 % b] = 0, 0
    got = edit_distance(torch.tensor(refs), torch.tensor(rl), torch.tensor(hyps), torch.tensor(hl))
    ref = np.asarray(jax.jit(jedit.edit_distance)(jnp.asarray(refs), jnp.asarray(rl), jnp.asarray(hyps), jnp.asarray(hl)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.numpy().tolist() == [_brute(list(refs[i, : rl[i]]), list(hyps[i, : hl[i]])) for i in range(b)]
    num, den = wer_on_device(torch.tensor(refs), torch.tensor(rl), torch.tensor(hyps), torch.tensor(hl))
    jnum, jden = jedit.wer_on_device(jnp.asarray(refs), jnp.asarray(rl), jnp.asarray(hyps), jnp.asarray(hl))
    assert (int(num), int(den)) == (int(jnum), int(jden))


# ------------------------------ the slice --------------------------------- #

TEXTS = ["ab cd", "the cat", "a dog's", "ef gh"]
TRANSDUCER_CFG = {**TINY_CFG, "vocab_size": 29, "encoder_num_blocks": 1}
CTC_CFG = {**CONFORMER_CFG, "vocab_size": 29, "encoder_num_blocks": 1}
MODELS = {"conformer_t": (JConformer, Conformer, TRANSDUCER_CFG), "conformer_ctc": (JConformerCtc, ConformerCtc, CTC_CFG)}


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Four utterances of 0.3-0.6 s, WAV and FLAC, with the char tokenizers."""
    root = tmp_path_factory.mktemp("slice")
    rng = np.random.default_rng(3)
    rows = []
    for i, text in enumerate(TEXTS):
        n = int(rng.integers(4800, 9600))
        x = (0.3 * np.sin(2 * np.pi * (150 + 90 * i) * np.arange(n) / 16000) + 0.05 * rng.standard_normal(n)).astype(np.float32)
        path = str(root / f"u{i}.{'flac' if i % 2 else 'wav'}")
        (audio.write_flac if i % 2 else audio.write_wav)(path, x, 16000)
        rows.append(f"{path}\t{n / 16000}\t{text}")
    path = root / "transcripts.tsv"
    path.write_text("PATH\tDURATION\tTRANSCRIPT\n" + "\n".join(rows) + "\n")
    tok, jtok = CharTokenizer(DecoderConfig({"type": "characters"})), JCharTokenizer(JDecoderConfig({"type": "characters"}))
    tok.make()
    jtok.make()
    return str(path), tok, jtok


def _datasets(manifest, stage: str = "eval"):
    path, tok, jtok = manifest
    ours = datasets.ASRSliceDataset(tok, stage=stage, data_paths=[path])
    theirs = jdatasets.ASRSliceDataset(jtok, stage=stage, data_paths=[path])
    ours.compute_metadata()
    theirs.compute_metadata()
    return ours, theirs


def _models(name: str, theirs):
    """The JAX model, its variables (BatchNorm statistics perturbed) and the port's model carrying them."""
    jcls, cls, cfg = MODELS[name]
    jm = jcls.from_config(cfg)
    batch = next(theirs.create(2, num_workers=0, prefetch=0))
    inputs = jax.tree_util.tree_map(jnp.asarray, batch.inputs)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(jax.random.PRNGKey(1), inputs))
    rng = np.random.default_rng(5)
    v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    tm = cls.from_config(cfg, device="cpu")
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    return jm, v, tm


@pytest.mark.parametrize("name", sorted(MODELS))
def test_evaluate_dataset_rows_and_error_rates_equal_jax(manifest, tmp_path, name):
    """Batches of 3: a full one and the remainder of 1."""
    batch_size = 3
    ours, theirs = _datasets(manifest)
    jm, v, tm = _models(name, theirs)
    ref = jevaluation.evaluate_dataset(jm, v, theirs, manifest[2], batch_size=batch_size, collect_rows=True)
    logger = callbacks.PredictLogger(output=str(tmp_path / "predictions.tsv"))
    got = evaluate_dataset(tm, ours, manifest[1], batch_size=batch_size, collect_rows=True, num_workers=2, predict_logger=logger)
    assert got["rows"] == ref["rows"] and len(got["rows"]) == len(TEXTS)
    assert got["greedy"] == ref["greedy"]
    assert (tmp_path / "predictions.tsv").read_text().splitlines()[1:] == ["\t".join(row) for row in ref["rows"]]
    # the beam column (beam search over the same batches; no LM) and the 4-tuple rows
    ref = jevaluation.evaluate_dataset(jm, v, theirs, manifest[2], batch_size=batch_size, beam_width=4, collect_rows=True)
    got = evaluate_dataset(tm, ours, manifest[1], batch_size=batch_size, beam_width=4, collect_rows=True, num_workers=2)
    assert got["rows"] == ref["rows"] and got["greedy"] == ref["greedy"] and got["beam"] == ref["beam"]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_two_data_fed_fit_steps_match_jax(manifest, monkeypatch, name):
    """``Trainer.fit`` over the port's dataset against two jitted JAX steps
    over JAX's, from the same weights; the parameters whose gradient is zero
    in exact arithmetic are frozen on both sides (``test_torch_train_slice.py``)."""
    ours, theirs = _datasets(manifest, stage="train")
    jm, v, tm = _models(name, theirs)
    monkeypatch.setenv("TFASR_LOSS_IMPL", "xla")
    port_name = lambda path: ".".join(str(k.key) for k in path if str(k.key) not in bridge._DROP)
    labels = jax.tree_util.tree_map_with_path(lambda path, _: "frozen" if port_name(path).endswith(FROZEN) else "adam", v["params"])
    tx = optax.chain(_record_grads(), optax.multi_transform({"adam": jbuild_optimizer(ADAM), "frozen": optax.set_to_zero()}, labels))
    state = jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, v), tx, jax.random.PRNGKey(0))
    step = jax.jit(jtrainer.make_train_step(jm, tx))
    jax_steps = []
    for batch in theirs.create(2, num_workers=0, prefetch=0):
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
        jax_steps.append((float(m["loss"]), bridge.state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, state.opt_state[0])})))
        if len(jax_steps) == 2:
            break

    class Record(callbacks.Callback):
        steps = []

        def on_train_batch_end(self, trainer, state, metrics):
            self.steps.append((float(metrics["loss"]), {n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.grad is not None}))

    trainer = Trainer(tm, ADAM, device="cpu", loss_impl="xla", callbacks=[Record()])
    tstate = trainer.init_state(seed=0)
    tstate.optimizer = build_optimizer(ADAM, [p for n, p in tm.named_parameters() if not n.endswith(FROZEN)])
    trainer.fit(tstate, ours.create(2, num_workers=2), epochs=1, steps_per_epoch=2)
    assert tstate.step == 2 and len(Record.steps) == 2
    for k, ((jl, jgrads), (tl, tgrads)) in enumerate(zip(jax_steps, Record.steps)):
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"loss at step {k}")
        gmax = max(np.abs(g.numpy()).max() for g in jgrads.values())
        assert set(tgrads) == {n for n in jgrads if not n.endswith(("running_mean", "running_var"))}
        for n, g in tgrads.items():
            _close_scaled(g.numpy(), jgrads[n].numpy(), floor=1e-6 * gmax, what=f"{n} at step {k}")
    gc_unfreeze()


def gc_unfreeze():
    """``Trainer.fit`` freezes the collector's survivors after its first step; undo it for the next tests."""
    import gc

    gc.unfreeze()


# ------------------------------- pipeline --------------------------------- #


def test_pipeline_builds_tokenizer_model_and_datasets_from_char_config(tmp_path):
    config = pipeline.load_config(os.path.join(REPO, "examples", "datasets", "librispeech", "characters", "char.yml.j2"), datadir=str(tmp_path))
    config.model_config = {"class_name": "tensorflow_asr.models.transducer.conformer>Conformer", "config": TRANSDUCER_CFG}
    tok = pipeline.build_tokenizer(config)
    assert type(tok) is CharTokenizer and tok.num_classes == 29 and config.decoder_config.vocabulary.endswith("english.vocab")
    model = pipeline.build_model_from_config(config, tok, device="cpu")
    assert type(model) is Conformer and model.vocab_size == 29 and model.dtype == torch.float32
    assert pipeline.build_model_from_config(config, tok, mxp="strict", device="cpu").dtype == torch.bfloat16
    data = pipeline.build_datasets(config, tok, stages=("train", "eval", "test"))
    assert data["train"].data_paths[0] == str(tmp_path / "train-clean-100" / "transcripts.tsv")
    assert [d.name for d in data["test"]] == ["test-clean", "test-other"] and data["eval"].stage == "eval"
    tfr = pipeline.build_datasets(config, tok, dataset_type="tfrecord", stages=("eval",), rank=1, world=2)["eval"]
    assert type(tfr) is datasets.ASRTFRecordDataset and tfr.tfrecords_shards == 2 and (tfr.rank, tfr.world) == (1, 2)


def test_data_tokenizer_and_evaluation_import_without_hf_tokenizers_or_yaml():
    code = ("import sys\n"
            "sys.modules['tokenizers'] = None\nsys.modules['yaml'] = None\n"
            "import tensorflowasr_tpu_torch.data.datasets, tensorflowasr_tpu_torch.tokenizers, tensorflowasr_tpu_torch.training.evaluation\n"
            "from tensorflowasr_tpu_torch import tokenizers\n"
            "from tensorflowasr_tpu_torch.configs import Config\n"
            f"cfg = Config({{'decoder_config': {{'type': 'characters', 'vocabulary': {os.path.join(REPO, 'examples', 'datasets', 'librispeech', 'characters', 'english.vocab')!r}}}}})\n"
            "tok = tokenizers.get(cfg)\ntok.make()\nassert tok.detokenize(tok.tokenize('Hello')) == 'hello'\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _import_roots(path: str) -> set:
    tree = ast.parse(open(path, encoding="utf-8").read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    return roots | {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module and not n.level}


def test_no_port_module_imports_jax_tensorflow_orbax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(REPO, "tensorflowasr_tpu_torch")) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    files += [os.path.join(REPO, "scripts_torch", f) for f in os.listdir(os.path.join(REPO, "scripts_torch")) if f.endswith(".py")]
    assert len(files) > 60
    for path in files:
        bad = _import_roots(path) & {"jax", "jaxlib", "flax", "optax", "tensorflow", "orbax", "tensorstore", "zstandard", "tensorflowasr_tpu"}
        assert not bad, (path, bad)
