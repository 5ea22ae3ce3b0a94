"""The port's training recipe (schedule, AdamW, clipping, gradient noise,
accumulation, gaussian weight noise, SpecAugment) vs the JAX package's
``make_train_step`` with its ``build_optimizer``, on the CPU; checkpoints,
resume, warm start, callbacks and the published recipes as data.

Parity: the tiny Conformer-T (``loss_impl="auto"``, JAX
``TFASR_LOSS_IMPL=auto``) and the tiny Conformer-CTC, one block each, f32, dropout 0, the
same weights and BatchNorm statistics on both sides, 6 micro-steps at
``ga_steps`` 2 (3 applied updates) of AdamW under a TransformerSchedule
with a string ``max_lr``, clipped at a norm below the gradients', gradient
noise from update 0 and weight noise from micro-step 1 on the encoder and
the prediction net. JAX's random draws are replayed and injected: its
SpecAugment masks (from the key each jitted step hands ``feature_augment``,
read back through ``jax.debug.callback``), its weight
noise (the gwn key, through ``bridge.py``) and its gradient noise (the
``PRNGKey(42)`` stream, through ``bridge.py``). Tolerances are those of
``test_torch_train_slice.py``: loss and ``grad_norm`` to 1e-5 relative at
every micro-step; the final parameters and running statistics to 1e-4 of
each tensor's largest magnitude. The gradient noise (stddev 0.01) sits far
above the f32 noise of the gradients that are zero in exact arithmetic, so
no parameter is frozen here.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.augmentations import Augmentation as JAugmentation
from tensorflowasr_tpu.configs import Config as JConfig
from tensorflowasr_tpu.models.ctc.conformer import ConformerCtc as JConformerCtc
from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu.optimizers import build_optimizer as jbuild_optimizer
from tensorflowasr_tpu.training import callbacks as jcallbacks
from tensorflowasr_tpu.training import trainer as jtrainer
from tensorflowasr_tpu_torch import bridge
from tensorflowasr_tpu_torch.models.config_utils import SPEC_AUGMENT
from tensorflowasr_tpu_torch.models.ctc.conformer import ConformerCtc, conformer_ctc_small_config, conformer_ctc_small_learning_config
from tensorflowasr_tpu_torch.models.ctc.transformer import transformer_ctc_base_config, transformer_ctc_base_learning_config
from tensorflowasr_tpu_torch.models.transducer.conformer import (Conformer, conformer_small_config, conformer_small_learning_config,
                                                                 conformer_small_streaming_config, conformer_small_streaming_learning_config)
from tensorflowasr_tpu_torch.training import callbacks
from tensorflowasr_tpu_torch.training.pretrained import warm_start
from tensorflowasr_tpu_torch.training.trainer import Trainer
from tests.test_torch_ctc_slice import CONFORMER_CFG as CTC_CFG
from tests.test_torch_slice import TINY_CFG
from tests.test_torch_train_slice import _batch, _close_scaled, _jax_batch, _torch_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, GA = 6, 2
AUG = {"feature_augment": {"time_masking": {"prob": 1.0, "num_masks": 3, "mask_factor": -1, "p_upperbound": 0.1, "mask_value": 0},
                           "freq_masking": {"prob": 1.0, "num_masks": 1, "mask_factor": 9, "mask_value": "mean"}}}
OPTIMIZER = {"class_name": "Adam", "config": {"learning_rate": {"class_name": "tensorflow_asr.optimizers.schedules>TransformerSchedule",
                                                                "config": {"dmodel": 16, "warmup_steps": 2, "max_lr": "0.05/(144**0.5)"}},
                                              "beta_2": 0.98, "epsilon": 1e-9, "weight_decay": 1e-2}}
GRADN = {"eta": 1e-4, "gamma": 0.55}
GWN = {"stddev": 0.01, "step": 1, "modules": ["encoder", "prediction"]}
CLIP = 5.0
# one Conformer block each: the JAX step's compile (Pallas in interpret mode, the chain, the noise) sets this file's time
MODELS = {"conformer_t": (JConformer, Conformer, {**TINY_CFG, "encoder_num_blocks": 1}),
          "conformer_ctc": (JConformerCtc, ConformerCtc, {**CTC_CFG, "encoder_num_blocks": 1})}


def _with_aug(cfg: dict, aug: dict = AUG) -> dict:
    return {**cfg, "speech_config": {**cfg["speech_config"], "augmentation_config": aug}}


def _mask_draws(key, method, size_cap: int, hi: int):
    """One example's (starts, widths) as JAX's masking ``augment`` draws them."""
    starts, widths = [], []
    for _ in range(method.num_masks):
        kp, kw, k0, key = jax.random.split(key, 4)
        on = int(jax.random.uniform(kp) <= method.prob)
        w = on * min(int(jax.random.randint(kw, (), 0, hi)), size_cap)
        starts.append(on * int(jax.random.randint(k0, (), 0, max(size_cap - w, 1))))
        widths.append(w)
    return starts, widths


def spy_feature_keys(mp: pytest.MonkeyPatch, keys: list) -> None:
    """Appends to ``keys`` the key each call of JAX's ``feature_augment``
    takes (flax's ``make_rng("augment")``, split), also inside ``jit``."""
    feature_augment = JAugmentation.feature_augment

    def spy(self, inputs, inputs_length, key):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), key)
        return feature_augment(self, inputs, inputs_length, key)

    mp.setattr(JAugmentation, "feature_augment", spy)


def replayed_masks(model, k_feat, frames: np.ndarray) -> list:
    """Per feature method of ``model``, the (starts, widths) JAX draws from the
    key its ``feature_augment`` took: per example, then per method."""
    n_bins = model.feature_extraction.config.num_feature_bins
    k_feat = jnp.asarray(k_feat)
    methods = model.feature_extraction.augmentation.feature_augmentations
    per_example = [jax.random.split(k, len(methods)) for k in jax.random.split(k_feat, len(frames))]
    out = []
    for i, method in enumerate(methods):
        rows = []
        for b, keys in enumerate(per_example):
            if hasattr(method, "p_upperbound"):
                bound = int(np.floor(np.float32(frames[b]) * np.float32(method.p_upperbound)))
                rows.append(_mask_draws(keys[i], method, int(frames[b]), max(bound, 1)))
            else:
                rows.append(_mask_draws(keys[i], method, n_bins, max(method.mask_factor, 1)))
        out.append((torch.tensor([r[0] for r in rows], dtype=torch.float64), torch.tensor([r[1] for r in rows], dtype=torch.float64)))
    return out


def _as_port(tree, names: list[str]) -> list[torch.Tensor]:
    """A params-shaped JAX tree as port tensors in the order of ``names``."""
    sd = bridge.state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, tree)})
    return [sd[n] for n in names]


def _gradient_noise_draws(params, updates: int) -> list:
    """JAX ``gradient_noise``'s unit normals per applied update, as trees like ``params``."""
    leaves, treedef = jax.tree_util.tree_flatten(params)

    @jax.jit
    def draw(key):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, len(leaves))
        return key, jax.tree_util.tree_unflatten(treedef, [jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)])

    key, out = jax.random.PRNGKey(42), []
    for _ in range(updates):
        key, tree = draw(key)
        out.append(tree)
    return out


def run_recipe(name: str):
    """STEPS micro-steps of the recipe on both sides; per micro-step (loss,
    grad_norm) and the final variables (JAX) / module (port)."""
    jax_cls, port_cls, base = MODELS[name]
    cfg = _with_aug(base)
    feature_keys = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFASR_LOSS_IMPL", "auto")
        spy_feature_keys(mp, feature_keys)
        rng = np.random.default_rng(0)
        arrs = _batch(rng)
        jm, jb = jax_cls.from_config(cfg), _jax_batch(arrs)
        v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(jax.random.PRNGKey(1), jb.inputs))
        v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
        tx = jbuild_optimizer(OPTIMIZER, ga_steps=GA, gradn_config=GRADN, clip_norm=CLIP)
        state = jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, v), tx, jax.random.PRNGKey(0))
        step = jax.jit(jtrainer.make_train_step(jm, tx, GWN))
        jax_steps = []
        for _ in range(STEPS):
            state, metrics = step(state, jb)
            jax_steps.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        jax_final = jax.tree_util.tree_map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})

    tm = port_cls.from_config(cfg, device="cpu")
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    trainer = Trainer(tm, OPTIMIZER, device="cpu", ga_steps=GA, gradn_config=GRADN, clip_norm=CLIP, gwn_config=GWN)
    tstate = trainer.init_state(seed=0)
    names = [n for n, _ in tm.named_parameters()]
    frames = tm.feature_extraction.get_nframes(torch.tensor(arrs[1]).long()).numpy()
    assert len(feature_keys) == STEPS
    masks = [replayed_masks(tm, k, frames) for k in feature_keys]
    for i, method in enumerate(tm.feature_extraction.augmentation.feature_augmentations):
        method.draw = lambda x, lengths, generator, i=i: masks[tstate.step][i]
    zeros = jax.tree_util.tree_map(jnp.zeros_like, v["params"])
    gwn = jax.jit(lambda step: jtrainer._apply_gwn(zeros, jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), step), 3)[2], GWN))
    noised = [n for n, _ in trainer.weight_noise.named]
    trainer.weight_noise.draw = lambda generator: _as_port(gwn(tstate.step), noised)  # 0 + stddev·N: exactly what JAX adds
    gradn = [_as_port(t, names) for t in _gradient_noise_draws(v["params"], STEPS // GA)]
    tstate.optimizer.gradient_noise.draw = lambda grads: gradn[tstate.optimizer.gradient_noise.count]
    tb = _torch_batch(arrs)
    torch_steps = []
    for _ in range(STEPS):
        tstate, metrics = trainer.train_step(tstate, tb)
        torch_steps.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    assert tstate.optimizer.count == STEPS // GA and tstate.step == STEPS
    return jax_steps, jax_final, torch_steps, tm, v


@pytest.fixture(scope="module", params=sorted(MODELS))
def recipe(request):
    return run_recipe(request.param)


def test_recipe_losses_and_grad_norms_match_jax(recipe):
    jax_steps, _, torch_steps, _, _ = recipe
    for k, ((jl, jn), (tl, tn)) in enumerate(zip(jax_steps, torch_steps)):
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"loss at micro-step {k}")
        np.testing.assert_allclose(tn, jn, rtol=1e-5, err_msg=f"grad_norm at micro-step {k}")
    assert all(n > CLIP for _, n in jax_steps)  # clipping acted on every update


def test_recipe_parameters_and_statistics_match_jax(recipe):
    _, jax_final, _, tm, v = recipe
    ref, got, start = bridge.state_dict_from_flax(jax_final), tm.state_dict(), bridge.state_dict_from_flax(v)
    assert set(got) == set(ref)
    for name, value in got.items():
        _close_scaled(value.numpy(), ref[name].numpy(), what=name)
        assert not torch.equal(value, start[name]), name  # every parameter and statistic moved


def _fresh_trainer(tmp_path, seed: int, **kwargs):
    model = Conformer.from_config(_with_aug({**TINY_CFG, "encoder_dropout": 0.1}, SPEC_AUGMENT), device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return Trainer(model, OPTIMIZER, device="cpu", ga_steps=GA, gradn_config=GRADN, clip_norm=CLIP, gwn_config=GWN,
                   checkpoint_dir=str(tmp_path / "ckpt"), keep_checkpoints=2, **kwargs)


def _state_tensors(trainer, state) -> dict:
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    for i, s in opt["base"]["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in s.items()})
    out.update({f"acc.{i}": a for i, a in enumerate(opt["accumulated"])})
    return out


def test_resume_equals_a_straight_run_bit_for_bit(tmp_path):
    """3 micro-steps, save (mid-accumulation), 3 more; a fresh trainer over a
    differently initialised model restores and runs the same 3: every loss,
    parameter, statistic, moment and buffer equal, dropout and all three
    noises from their own generators."""
    batch = _torch_batch(_batch(np.random.default_rng(4)))
    trainer = _fresh_trainer(tmp_path, seed=3)
    state = trainer.init_state(seed=5)
    for _ in range(3):
        trainer.train_step(state, batch)
    trainer.save(state)
    straight = [float(trainer.train_step(state, batch)[1]["loss"]) for _ in range(3)]
    other = _fresh_trainer(tmp_path, seed=9)
    resumed_state = other.restore(other.init_state(seed=6))
    assert resumed_state.step == 3 and resumed_state.optimizer.mini_step == 1 and resumed_state.optimizer.count == 1
    resumed = [float(other.train_step(resumed_state, batch)[1]["loss"]) for _ in range(3)]
    assert resumed == straight
    a, b = _state_tensors(trainer, state), _state_tensors(other, resumed_state)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for name, g in state.generators().items():
        assert torch.equal(g.get_state(), resumed_state.generators()[name].get_state()), name
    assert torch.equal(state.optimizer.gradient_noise.generator.get_state(), resumed_state.optimizer.gradient_noise.generator.get_state())


def test_checkpoints_rotate(tmp_path):
    trainer = _fresh_trainer(tmp_path, seed=3)
    state = trainer.init_state()
    batch = _torch_batch(_batch(np.random.default_rng(4)))
    for _ in range(3):
        trainer.train_step(state, batch)
        trainer.save(state)
    assert trainer.checkpoint_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "3"]


def test_warm_start_by_name_and_shape(tmp_path, caplog):
    """A smaller vocabulary's checkpoint seeds a model: everything but the
    vocabulary-sized tensors loads, BatchNorm statistics included."""
    trainer = _fresh_trainer(tmp_path, seed=3)
    state = trainer.init_state()
    state.step = 7
    with torch.no_grad():
        for _, buf in state.model.named_buffers():
            buf.add_(0.5)
    trainer.save(state)
    torch.save(state.model.state_dict(), tmp_path / "weights.pt")
    src = state.model.state_dict()
    for path in (tmp_path / "ckpt", tmp_path / "ckpt" / "7", tmp_path / "weights.pt"):
        model = Conformer.from_config({**TINY_CFG, "vocab_size": 12}, device="cpu")
        model.reset_parameters(torch.Generator().manual_seed(8))
        target = Trainer(model, OPTIMIZER, device="cpu")
        with caplog.at_level(logging.WARNING, logger="tensorflowasr_tpu_torch"):
            warm_start(target.init_state(), str(path))
        mismatched = {k for k, v in src.items() if v.shape != model.state_dict()[k].shape}
        assert mismatched and all(k.startswith(("joint.vocab", "prediction.embedding")) for k in mismatched)
        assert all(m in caplog.text for m in mismatched)
        for k, v in model.state_dict().items():
            assert torch.equal(v, src[k]) == (k not in mismatched), k
    torch.save({"unrelated": torch.zeros(3)}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="no same-shaped"):
        warm_start(Trainer(model, OPTIMIZER, device="cpu").init_state(), str(tmp_path / "other.pt"))


def _tiny_trainer(optimizer: dict, cbs: list, tmp_path=None):
    model = Conformer.from_config(TINY_CFG, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(6))
    return Trainer(model, optimizer, device="cpu", callbacks=cbs, checkpoint_dir=str(tmp_path / "ckpt") if tmp_path else None)


def test_terminate_on_nan_stops_fit(tmp_path):
    good = _torch_batch(_batch(np.random.default_rng(7)))
    arrs = list(_batch(np.random.default_rng(7)))
    arrs[0] = np.full_like(arrs[0], np.nan)
    bad = _torch_batch(tuple(arrs))
    tb = callbacks.TensorBoard(log_dir=str(tmp_path / "tb"), update_freq=1)
    trainer = _tiny_trainer({"class_name": "Adam", "config": {"learning_rate": 1e-3}}, [callbacks.TerminateOnNaN(), tb], tmp_path)
    state = trainer.fit(trainer.init_state(), [good, good, bad, good, good], epochs=3)
    assert state.step == 3 and trainer.callbacks[0].stop_training
    assert trainer.checkpoint_steps() == [3]
    lines = [json.loads(line) for line in open(tmp_path / "tb" / "metrics.jsonl")]
    assert [d["step"] for d in lines] == [1, 2, 3, 3] and "epoch_loss" in lines[-1]


def test_early_stopping_stops_fit():
    batch = _torch_batch(_batch(np.random.default_rng(7)))
    stopper = callbacks.EarlyStopping(monitor="val_loss", patience=1)
    trainer = _tiny_trainer({"class_name": "SGD", "config": {"learning_rate": 0.0}}, [stopper])
    state = trainer.fit(trainer.init_state(), [batch], epochs=6, eval_data=[batch])
    assert state.step == 2 and stopper.stop_training and stopper.wait == 1  # no improvement at lr 0: stops after the second epoch


EXAMPLES = {
    "transducer/conformer/small": (conformer_small_learning_config, lambda: conformer_small_config(vocab_size=1000, augment=True)),
    "transducer/conformer/small-streaming": (conformer_small_streaming_learning_config, lambda: conformer_small_streaming_config(augment=True)),
    "ctc/conformer/small": (conformer_ctc_small_learning_config, lambda: conformer_ctc_small_config(augment=True)),
    "ctc/transformer/base": (transformer_ctc_base_learning_config, lambda: transformer_ctc_base_config(augment=True)),
}


@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_published_recipes_as_the_config_loader_parses_them(monkeypatch, tmp_path, example):
    """Each recipe function equals the JAX loader's ``learning_config`` of the
    example, and ``augment=True`` its ``augmentation_config``; ``deserialize``
    builds the callbacks JAX's registry holds, in order, and skips an unknown kind."""
    monkeypatch.setenv("TFASR_MODELDIR", str(tmp_path))
    learning, model = EXAMPLES[example]
    cfg = JConfig(os.path.join(REPO, "examples", "models", example + ".yml.j2"))
    assert (learning(str(tmp_path)) if example == "transducer/conformer/small" else learning()) == vars(cfg.learning_config)
    assert model()["speech_config"]["augmentation_config"] == cfg.model_config["config"]["speech_config"]["augmentation_config"]
    ours = callbacks.deserialize(cfg.learning_config.callbacks + [{"class_name": "tensorflow_asr.callbacks>KaggleModelBackupAndRestore", "config": {}}])
    theirs = [c["class_name"].split(">")[-1] for c in cfg.learning_config.callbacks if c["class_name"].split(">")[-1] in jcallbacks.CALLBACKS]
    assert [type(c).__name__ for c in ours] == theirs and theirs[0] == "TerminateOnNaN"
    for c in ours:
        if isinstance(c, callbacks.TensorBoard):
            assert c.log_dir == str(tmp_path / "tensorboard") and os.path.isdir(c.log_dir)
            c.close()
