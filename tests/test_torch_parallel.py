"""Data- and tensor-parallel training across processes (``parallel/``) vs
the JAX package, on the CPU: gloo ranks started by ``parallel.spawn``.

Each world is spawned once, in a module-scoped fixture. Its workers are
this module's functions and import no JAX (this module imports JAX only
inside the fixtures, in the parent): the parent computes the JAX side on
conftest's 8 virtual CPU devices (so JAX's ``Trainer`` step is itself
data-parallel over 8) and hands the workers numpy weights and batches;
the workers return numpy results.

The model is the tiny Conformer-T of ``tests/test_parallel.py:_tiny_transducer``
(its conv module has a BatchNorm) at nfft 512: the port's log-mel frontend
takes no nfft below the frame length (400 samples), which JAX's XLA
frontend truncates. JAX runs the scan DP loss (conftest's
``TFASR_LOSS_IMPL=xla``), the port its default fused joint + loss (the
plain versions on the CPU). SGD 1e-2, not Adam: Adam's first update is
±lr·sign(g), which turns float noise on near-zero gradients into
full-size differences (``tests/test_parallel.py:217-219``).

Tolerances, those of JAX's ``test_tp_vocab_sharded_step_matches_dp``: the
loss and ``grad_norm`` to 2e-5, parameters and running statistics to rtol
2e-4, atol 2e-5; the vocab-sharded loss to 1e-5.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch import bridge, parallel, schemas
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tensorflowasr_tpu_torch.ops.rnnt_loss import rnnt_loss
from tensorflowasr_tpu_torch.parallel import tp
from tensorflowasr_tpu_torch.parallel.collectives import psum, psum_replicated
from tensorflowasr_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = {
    "speech_config": {"sample_rate": 16000, "frame_ms": 25, "stride_ms": 10, "nfft": 512, "num_feature_bins": 20},
    "encoder_subsampling": {
        "class_name": "tensorflow_asr.models.layers.subsampling>Conv2dSubsampling",
        "config": {"filters": [8, 8], "kernels": [3, 3], "strides": [2, 2], "paddings": ["causal", "causal"], "norms": ["layer", "layer"],
                   "activations": ["swish", "swish"]},
    },
    "encoder_dmodel": 16,
    "encoder_num_blocks": 1,
    "encoder_head_size": 4,
    "encoder_num_heads": 2,
    "encoder_mha_type": "relmha",
    "encoder_kernel_size": 7,
    "encoder_dropout": 0.0,
    "prediction_embed_dim": 8,
    "prediction_num_rnns": 1,
    "prediction_rnn_units": 8,
    "joint_dim": 8,
    "vocab_size": 24,
}
SGD = {"class_name": "SGD", "config": {"learning_rate": 1e-2}}
K_STEPS = 3
LOSS_TOL, RTOL, ATOL = 2e-5, 2e-4, 2e-5
TP_LOSS_SHAPE = (4, 6, 5, 16)  # B, T, U+1, V (JAX test_tp_loss_matches_unsharded_loss)


def _arrays(b: int, identical: bool, seed: int = 0, zero_row=None) -> tuple:
    """(signal, lengths, predictions, prediction lengths, labels, label lengths) as
    ``tests/test_parallel.py:_tp_batch`` makes them; ``zero_row``: that row gets length 0."""
    rng = np.random.default_rng(seed)
    sig = rng.standard_normal((1, 1600)).astype(np.float32)
    lab = rng.integers(1, 24, (1, 4)).astype(np.int32)
    if identical:
        sig, lab = np.repeat(sig, b, axis=0), np.repeat(lab, b, axis=0)
    else:
        sig = rng.standard_normal((b, 1600)).astype(np.float32)
        lab = rng.integers(1, 24, (b, 4)).astype(np.int32)
    lens = np.full((b,), 1600, np.int32)
    if zero_row is not None:
        lens[zero_row] = 0
    return sig, lens, np.pad(lab, ((0, 0), (1, 0))), np.full((b,), 5, np.int32), lab, np.full((b,), 4, np.int32)


def _torch_batch(arrs, rows=slice(None)) -> schemas.TrainData:
    sig, lens, preds, plen, labels, llen = (torch.tensor(a[rows]) for a in arrs)
    return schemas.TrainData(schemas.TrainInput(sig, lens.long(), preds.long(), plen.long()), schemas.TrainLabel(labels.long(), llen.long()))


def _port_model(sd: dict) -> Conformer:
    model = Conformer.from_config(CFG, device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return model


def _numpy_state(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _train(sd: dict, arrs, rows, steps: int) -> tuple[list, list]:
    """``steps`` SGD steps of a ``Trainer`` (data-parallel under a group of more than one rank) on ``rows``:
    (loss, grad_norm) per step and the state after each."""
    trainer = Trainer(_port_model(sd), SGD, device="cpu")
    state = trainer.init_state(seed=0)
    metrics, states = [], []
    for _ in range(steps):
        state, m = trainer.train_step(state, _torch_batch(arrs, rows))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        states.append(_numpy_state(trainer.model))
    return metrics, states


# ------------------------- spawned workers (no JAX) -------------------------- #


def _world2_worker(sd: dict, distinct, uneven) -> dict:
    torch.set_num_threads(2)
    rank = parallel.process_index()
    out = {"dp": _train(sd, distinct, slice(4 * rank, 4 * rank + 4), K_STEPS), "uneven": _train(sd, uneven, [slice(0, 5), slice(5, 8)][rank], 1)}
    for name, fn in (("psum", psum), ("psum_replicated", psum_replicated)):
        x = torch.tensor([rank + 1.0], requires_grad=True)
        y = fn(2.0 * x)
        y.sum().backward()
        out[name] = (float(y), float(x.grad))
    return out


def _world4_worker(logits: np.ndarray, labels: np.ndarray, sd: dict, identical) -> dict:
    torch.set_num_threads(2)
    b, t, u1, v = logits.shape
    mesh = tp.make_dp_tp_mesh(4, "cpu")  # data 1 x model 4
    n, index = tp.model_coords(mesh)
    local = torch.tensor(logits).chunk(n, -1)[index].clone().requires_grad_(True)
    per = tp.tp_rnnt_loss(local, torch.full((b,), t), torch.tensor(labels), torch.full((b,), u1 - 1), v, mesh.get_group("model"))
    per.sum().backward()
    out = {"tp_loss": per.detach().numpy(), "tp_dlogits": local.grad.numpy(), "tp_index": index}

    mesh = tp.make_dp_tp_mesh(2, "cpu")  # data 2 x model 2
    state = tp.init_tp_state(_port_model(sd), SGD, mesh, seed=0)
    step = tp.make_tp_train_step(state.model, mesh)
    data = mesh.get_local_rank("data")
    state, m = step(state, _torch_batch(identical, slice(4 * data, 4 * data + 4)))
    out["tp_step"] = (float(m["loss"]), float(m["grad_norm"]), {k: v.numpy().copy() for k, v in tp.gather_tp_state(state.model.state_dict(), mesh).items()})
    out["tp_vocab_rows"] = state.model.joint.vocab.weight.shape[0]
    return out


# --------------------------------- fixtures ---------------------------------- #


@pytest.fixture(scope="module")
def jax_side():
    """JAX ``Trainer`` (SGD, 8 virtual devices): K steps on 8 distinct rows and
    one on 8 identical rows from the same start, and ``tp.tp_rnnt_loss`` under
    ``shard_map`` (data 2 x model 4) with the unsharded loss."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from tensorflowasr_tpu import schemas as jschemas
    from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
    from tensorflowasr_tpu.optimizers import build_optimizer
    from tensorflowasr_tpu.parallel import tp as jtp
    from tensorflowasr_tpu.training import Trainer as JTrainer
    from tensorflowasr_tpu.training.trainer import TrainState as JTrainState

    def jbatch(arrs):
        sig, lens, preds, plen, labels, llen = map(jnp.asarray, arrs)
        return jschemas.TrainData(jschemas.TrainInput(sig, lens, preds, plen), jschemas.TrainLabel(labels, llen))

    def port_state(state) -> dict:
        variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
        return {k: v.numpy() for k, v in bridge.state_dict_from_flax(variables).items()}

    distinct, identical = _arrays(8, identical=False), _arrays(8, identical=True)
    model = JConformer.from_config(CFG, dtype=jnp.float32)
    trainer = JTrainer(model, build_optimizer(SGD))
    # Trainer.init_state's weights, initialised under jit (its eager init takes ~20 s on 8 devices)
    variables = jax.device_get(jax.jit(lambda k, x: model.init({"params": k}, x, train=False))(jax.random.PRNGKey(7), jbatch(distinct).inputs))

    def init_state():
        return jax.device_put(JTrainState.create(variables, trainer.tx, jax.random.PRNGKey(7)), trainer._rep)

    state = init_state()
    out = {"sd": port_state(state), "distinct": distinct, "identical": identical, "dp": ([], [])}
    for _ in range(K_STEPS):
        state, m = trainer.train_step(state, jbatch(distinct))
        out["dp"][0].append((float(m["loss"]), float(m["grad_norm"])))
        out["dp"][1].append(port_state(state))
    state, m = trainer.train_step(init_state(), jbatch(identical))
    out["identical_step"] = (float(m["loss"]), float(m["grad_norm"]), port_state(state))

    b, t, u1, v = TP_LOSS_SHAPE
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((b, t, u1, v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u1 - 1)).astype(np.int32)
    tl, ul = jnp.full((b,), t, jnp.int32), jnp.full((b,), u1 - 1, jnp.int32)
    fn = shard_map(lambda lg, t_, lb, u_: jtp.tp_rnnt_loss(lg, t_, lb, u_, v), mesh=jtp.make_dp_tp_mesh(n_model=4),
                   in_specs=(P("data", None, None, "model"), P("data"), P("data"), P("data")), out_specs=P("data"), check_vma=False)
    out["tp_logits"], out["tp_labels"] = logits, labels
    out["jax_tp_loss"] = np.asarray(jax.jit(fn)(jnp.asarray(logits), tl, jnp.asarray(labels), ul))
    return out


@pytest.fixture(scope="module")
def world2(jax_side):
    uneven = _arrays(8, identical=False, seed=1, zero_row=6)
    results = parallel.spawn(_world2_worker, 2, jax_side["sd"], jax_side["distinct"], uneven, device="cpu")
    return results, _train(jax_side["sd"], uneven, slice(None), 1)


@pytest.fixture(scope="module")
def world4(jax_side):
    return parallel.spawn(_world4_worker, 4, jax_side["tp_logits"], jax_side["tp_labels"], jax_side["sd"], jax_side["identical"], device="cpu")


def _assert_state(got: dict, ref: dict, rtol: float = RTOL, atol: float = ATOL) -> None:
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol, err_msg=k)


# ----------------------------------- tests ----------------------------------- #


@pytest.mark.parametrize("step", [0, K_STEPS - 1])
def test_dp_steps_match_jax_trainer_on_the_global_batch(world2, jax_side, step):
    """2 ranks x 4 rows against JAX's 8-device step on the same 8 rows: after
    one SGD step and after three, the loss, ``grad_norm``, every parameter and
    the conv module's BatchNorm running statistics; both ranks bit-equal."""
    (r0, r1), _ = world2
    jmetrics, jstates = jax_side["dp"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["dp"][0][step], jmetrics[step], rtol=LOSS_TOL, atol=LOSS_TOL)
        _assert_state(r["dp"][1][step], jstates[step])
    assert r0["dp"][0] == r1["dp"][0]
    for k in r0["dp"][1][step]:
        np.testing.assert_array_equal(r0["dp"][1][step][k], r1["dp"][1][step][k], err_msg=k)
    assert any("running_mean" in k for k in r0["dp"][1][step])


def test_dp_uneven_shards_match_the_single_process_step(world2):
    """5 and 3 rows, one of zero length: the global masked mean, BatchNorm over
    all 8 rows' frames, the summed gradients, as one process on the 8 rows."""
    (r0, r1), (ref_metrics, ref_states) = world2
    for r in (r0, r1):
        np.testing.assert_allclose(r["uneven"][0][0], ref_metrics[0], rtol=LOSS_TOL, atol=LOSS_TOL)
        _assert_state(r["uneven"][1][0], ref_states[0])
    for k in r0["uneven"][1][0]:
        np.testing.assert_array_equal(r0["uneven"][1][0][k], r1["uneven"][1][0][k], err_msg=k)


@pytest.mark.parametrize("name, grad", [("psum", 4.0), ("psum_replicated", 2.0)])
def test_psum_backward_rules(world2, name, grad):
    """y = Σ_ranks 2x on 2 ranks (x = 1, 2): y = 6; d(Σ_ranks y)/dx = 4 through
    ``psum`` (the backward all-reduces), 2 through ``psum_replicated`` (identity)."""
    (r0, r1), _ = world2
    assert r0[name] == r1[name] == (6.0, grad)


def test_tp_rnnt_loss_matches_jax_and_the_unsharded_gradient(world4, jax_side):
    """4 model ranks: the loss equals JAX's ``tp_rnnt_loss`` under ``shard_map``
    and each rank's gradient equals its columns of the unsharded loss's
    (a psum-again backward would scale it by 4)."""
    b, t, u1, v = TP_LOSS_SHAPE
    full = torch.tensor(jax_side["tp_logits"], requires_grad=True)
    ref = rnnt_loss(full, torch.full((b,), t), torch.tensor(jax_side["tp_labels"]).long(), torch.full((b,), u1 - 1))
    ref.sum().backward()
    for r in world4:
        np.testing.assert_allclose(r["tp_loss"], jax_side["jax_tp_loss"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["tp_loss"], ref.detach().numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["tp_dlogits"], full.grad.chunk(4, -1)[r["tp_index"]].numpy(), rtol=1e-5, atol=1e-6)


def test_tp_step_matches_jax_dp_step(world4, jax_side):
    """Data 2 x model 2 on identical rows (so each shard's BatchNorm statistics
    and masked mean equal the global ones): the loss, ``grad_norm`` and the
    updated parameters with the vocab slices gathered back equal JAX's DP
    ``Trainer`` step; each rank holds V/2 vocab rows."""
    jloss, jnorm, jstate = jax_side["identical_step"]
    for r in world4:
        loss, norm, state = r["tp_step"]
        np.testing.assert_allclose((loss, norm), (jloss, jnorm), rtol=LOSS_TOL, atol=LOSS_TOL)
        _assert_state(state, jstate)
        assert r["tp_vocab_rows"] == CFG["vocab_size"] // 2


def test_tp_state_slices_the_vocab_and_its_optimizer_state():
    """``shard_tp_state`` of a ``Trainer`` checkpoint: the vocab rows of the
    weights and of Adam's moments, the other entries as they were; a joint
    built with ``joint_config["vocab_size"]`` has the slice's shape."""
    model = Conformer.from_config(CFG, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": 1e-3}}, device="cpu")
    state, _ = trainer.train_step(trainer.init_state(), _torch_batch(_arrays(2, identical=False)))
    ckpt = {"model": model.state_dict(), "optimizer": state.optimizer.state_dict(), "step": state.step}
    names = [n for n, _ in model.named_parameters()]
    local = tp.shard_tp_state(ckpt, 2, 1, names)
    for i, name in enumerate(names):
        full, got = ckpt["optimizer"]["base"]["state"][i]["exp_avg"], local["optimizer"]["base"]["state"][i]["exp_avg"]
        torch.testing.assert_close(got, full[12:] if name in tp.VOCAB_PARAMS else full, rtol=0, atol=0)
    assert local["model"]["joint.vocab.weight"].shape == (12, CFG["joint_dim"]) and local["step"] == state.step
    assert tp.param_specs(model)["joint.vocab.bias"] == 0 and tp.param_specs(model)["prediction.embedding.embeddings.weight"] is None
    sliced = Conformer.from_config(CFG, device="cpu")
    kwargs = dict(speech_config=sliced.speech_config, encoder_config=sliced.encoder_config, prediction_config=sliced.prediction_config,
                  joint_config={**sliced.joint_config, "vocab_size": 12}, vocab_size=24, device="cpu")
    built = Conformer(**kwargs)
    assert built.joint.vocab.weight.shape == (12, CFG["joint_dim"]) and built.prediction.embedding.embeddings.weight.shape[0] == 24


TB_CALLBACK = """    - class_name: tensorflow_asr.callbacks>TensorBoard
      config:
        log_dir: {{modeldir}}/tensorboard
        update_freq: 1
"""


def test_cli_train_under_torchrun_on_two_gloo_ranks(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m tensorflowasr_tpu_torch
    train --device cpu`` for 2 steps on the CLI test's DeepSpeech2-tiny corpus:
    rank 0 logs the shapes of a global batch of 4 and the global loss after
    checking that both ranks hold the same parameters bit for bit; rank 1 logs
    nothing; one checkpoint is written and TensorBoard's file holds one rank's lines."""
    from tensorflowasr_tpu_torch.data import audio
    from tensorflowasr_tpu_torch.scripts import main
    from tests.test_torch_cli import CONFIG

    datadir, modeldir = tmp_path / "data", tmp_path / "model"
    datadir.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(["hello world", "speech test", "jax on tpu", "tiny data"]):
        sig = (0.3 * np.sin(2 * np.pi * (300 + 50 * i) * np.arange(3200) / 16000) + 0.01 * rng.standard_normal(3200)).astype(np.float32)
        audio.write_wav(str(datadir / f"{i}.wav"), sig, 16000)
        rows.append(f"{datadir / f'{i}.wav'}\t0.2\t{text}")
    (datadir / "train.tsv").write_text("PATH\tDURATION\tTRANSCRIPT\n" + "\n".join(rows) + "\n")
    config = tmp_path / "config.yml.j2"
    config.write_text(CONFIG.replace("      config: {}\n", "      config: {}\n" + TB_CALLBACK))
    common = ["--config-path", str(config), "--datadir", str(datadir), "--modeldir", str(modeldir), "--device", "cpu"]
    assert main(["utils", "create_datasets_metadata", *common]) == 0
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", "-m", "tensorflowasr_tpu_torch",
                           "train", *common, "--epochs", "1", "--steps-per-epoch", "2", "--mxp", "none"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    assert re.search(r"'batch_size': 4, 'local_batch_size': 2.*\(2 processes", log), log[-4000:]
    done = re.findall(r"data-parallel over 2 ranks: step 2, loss ([0-9.]+), parameters and buffers equal on every rank", log)
    assert len(done) == 1 and np.isfinite(float(done[0])), log[-4000:]
    assert len(re.findall(r"\[INFO\] tensorflowasr_tpu_torch: shapes:", log)) == 1  # rank 0 alone logs
    assert sorted(os.listdir(modeldir / "checkpoints")) == ["2"]
    lines = (modeldir / "tensorboard" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3  # steps 1 and 2 and the epoch's end, written once


def _raise_on_rank_1() -> int:
    if parallel.process_index() == 1:
        raise ValueError("rank 1 fails")
    return parallel.process_index()


def test_spawn_raises_a_rank_failure():
    """A rank's exception reaches the caller with its traceback; no result is returned."""
    with pytest.raises(RuntimeError, match="(?s)spawned rank 1 of 2 failed.*rank 1 fails"):
        parallel.spawn(_raise_on_rank_1, 2, device="cpu", timeout=120)


def test_no_fallback_without_a_card(monkeypatch):
    """Without a card a process group on the default device raises (no silent
    CPU), NCCL on the CPU raises, and so does a Trainer without device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.init_process_group(rank=0, world=1, init_method="tcp://localhost:1")
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA device"):
        parallel.init_process_group("cpu", "nccl", rank=0, world=1, init_method="tcp://localhost:1")
    with pytest.raises(RuntimeError, match="no torchrun environment"):
        monkeypatch.delenv("RANK", raising=False)
        parallel.init_process_group("cpu")


def test_batches_pad_to_devices_with_zero_length_rows():
    """``pad_batch_to_devices`` appends zero rows (JAX pads to its local devices);
    ``shard_batch`` with one card a process pads nothing."""
    from tensorflowasr_tpu_torch.parallel.sharding import pad_batch_to_devices

    batch = _torch_batch(_arrays(3, identical=False))
    padded = pad_batch_to_devices(batch, 4)
    assert padded.inputs.inputs.shape[0] == 4 and padded.inputs.inputs_length.tolist() == [1600, 1600, 1600, 0]
    assert padded.labels.labels_length.tolist()[-1] == 0 and float(padded.inputs.inputs[3].abs().sum()) == 0.0
    assert parallel.shard_batch(batch, "cpu").inputs.inputs.shape[0] == 3
