"""The port's CTC models vs the JAX package, on the CPU, at f32: a tiny
Conformer-CTC (per-layer attention biases, kernel B) and a tiny
Transformer-CTC (post-norm, vanilla MHA through kernel A), with the CTC
kernel's and kernel A's plain versions on the port's side and JAX's Pallas
kernels in interpret mode.

- Forward logits to 1e-4 of their largest magnitude (f32 summation order
  through the blocks), greedy and beam (W 4) tokens equal.
- The ``auto`` (CTC kernel) and ``xla`` (plain α recursion) training steps
  against JAX ``make_train_step`` under the matching ``TFASR_LOSS_IMPL``,
  with the checks and tolerances of ``test_torch_train_slice.py`` (its
  module docstring): loss and ``grad_norm`` to 1e-5 relative, every
  gradient and, after 3 Adam steps, every parameter and running statistic
  to 1e-4 of its tensor's largest magnitude.
- The eval step against JAX ``make_eval_step`` (default and ``xla``) to
  1e-5 relative.
- Train-time augmentation: a config with SpecAugment trains as JAX does
  (JAX's masks replayed), and evaluates and serves without augmenting (JAX
  augments only when training).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.models.ctc import base as jbase
from tensorflowasr_tpu.models.ctc.conformer import ConformerCtc as JConformerCtc
from tensorflowasr_tpu.models.ctc.transformer import TransformerCtc as JTransformerCtc
from tensorflowasr_tpu.training import trainer as jtrainer
from tensorflowasr_tpu_torch import bridge, schemas
from tensorflowasr_tpu_torch.models.ctc.base import recognize
from tensorflowasr_tpu_torch.models.ctc.conformer import ConformerCtc
from tensorflowasr_tpu_torch.models.ctc.transformer import TransformerCtc
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tensorflowasr_tpu_torch.training.trainer import Trainer
from tests.test_torch_slice import TINY_CFG
from tests.test_torch_train_slice import (ADAM, _batch, _jax_batch, _torch_batch, check_first_step_every_gradient, check_first_step_loss_and_grad_norm,
                                          check_k_adam_steps, run_both)

_COMMON = {"speech_config": TINY_CFG["speech_config"], "encoder_subsampling": TINY_CFG["encoder_subsampling"], "encoder_dropout": 0.0, "blank": 0,
           "vocab_size": 20}
CONFORMER_CFG = {**_COMMON, "encoder_dmodel": 16, "encoder_num_blocks": 2, "encoder_head_size": 4, "encoder_num_heads": 4,
                 "encoder_mha_type": "relmha", "encoder_mhsam_use_attention_bias": True, "encoder_kernel_size": 7}
TRANSFORMER_CFG = {**_COMMON, "encoder_dmodel": 16, "encoder_dff": 24, "encoder_num_blocks": 2, "encoder_head_size": 8, "encoder_num_heads": 2,
                   "encoder_mha_type": "mha", "encoder_norm_position": "post", "encoder_residual_factor": 1.0, "encoder_pwffn_activation": "relu"}
MODELS = {"conformer": (JConformerCtc, ConformerCtc, CONFORMER_CFG), "transformer": (JTransformerCtc, TransformerCtc, TRANSFORMER_CFG)}
SPEC_AUGMENT = {"feature_augment": {"time_masking": {"prob": 1.0, "num_masks": 2, "mask_factor": -1, "p_upperbound": 0.05, "mask_value": 0},
                                    "freq_masking": {"prob": 1.0, "num_masks": 1, "mask_factor": 5, "mask_value": 0}}}


def _variables(jm, jb, rng, key=1):
    v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(jax.random.PRNGKey(key), jb.inputs))
    v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    return v


def _both(name: str, cfg: dict | None = None):
    jax_cls, port_cls, base_cfg = MODELS[name]
    cfg = cfg or base_cfg
    rng = np.random.default_rng(11)
    arrs = _batch(rng)
    jm, jb = jax_cls.from_config(cfg), _jax_batch(arrs)
    v = _variables(jm, jb, rng)
    tm = port_cls.from_config(cfg, device="cpu")
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    return jm, v, tm, arrs


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_and_greedy_tokens_match_jax(name):
    jm, v, tm, arrs = _both(name)
    sig, lens = arrs[0], arrs[1]
    ref, ref_len, _ = jax.jit(lambda v_, s_, l_: jm.apply(v_, s_, l_, method=jm.encode))(v, jnp.asarray(sig), jnp.asarray(lens))
    tm.eval()
    with torch.inference_mode():
        got, got_len, _ = tm.encode(torch.tensor(sig), torch.tensor(lens))
        train_out = tm(_torch_batch(arrs).inputs, train=False)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    scale = np.abs(np.asarray(ref)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(train_out.logits.numpy(), got.numpy())
    pin = jschemas.PredictInput(jnp.asarray(sig), jnp.asarray(lens), None, None, None)
    ref_out = jax.jit(lambda v_, p_: jbase.recognize(jm, v_, p_))(v, pin)
    out = recognize(tm, schemas.PredictInput(torch.tensor(sig), torch.tensor(lens)))
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref_out.tokens))
    np.testing.assert_array_equal(out.next_tokens.numpy(), np.asarray(ref_out.next_tokens))
    # beam search through the same entry point (no LM here; tests/test_torch_beam_lm.py fuses one)
    ref_beam = jax.jit(lambda v_, p_: jbase.recognize(jm, v_, p_, beam_width=4))(v, pin)
    beam = recognize(tm, schemas.PredictInput(torch.tensor(sig), torch.tensor(lens)), beam_width=4)
    np.testing.assert_array_equal(beam.tokens.numpy(), np.asarray(ref_beam.tokens))


CASES = [(name, impl) for name in sorted(MODELS) for impl in ("auto", "xla")]


@pytest.fixture(scope="module", params=CASES, ids=[f"{name}-{impl}" for name, impl in CASES])
def runs(request):
    name, loss_impl = request.param
    jax_cls, port_cls, cfg = MODELS[name]
    return run_both(loss_impl, cfg=cfg, jax_cls=jax_cls, port_cls=port_cls)


def test_train_step_loss_and_grad_norm_match_jax(runs):
    check_first_step_loss_and_grad_norm(runs)


def test_train_step_every_gradient_matches_jax(runs):
    check_first_step_every_gradient(runs)


def test_train_k_adam_steps_match_jax(runs):
    check_k_adam_steps(runs)


def _eval_both(monkeypatch, name: str, loss_impl: str, cfg: dict | None = None):
    if loss_impl == "auto":
        monkeypatch.delenv("TFASR_LOSS_IMPL", raising=False)
    else:
        monkeypatch.setenv("TFASR_LOSS_IMPL", loss_impl)
    jm, v, tm, arrs = _both(name, cfg)
    state = jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, v), optax.adam(1e-3), jax.random.PRNGKey(0))
    ref = float(jax.jit(jtrainer.make_eval_step(jm))(state, _jax_batch(arrs))["loss"])
    trainer = Trainer(tm, ADAM, device="cpu", loss_impl=loss_impl)
    return float(trainer.eval_step(trainer.init_state(), _torch_batch(arrs))["loss"]), ref, trainer


@pytest.mark.parametrize("name,loss_impl", CASES)
def test_eval_step_matches_jax(monkeypatch, name, loss_impl):
    got, ref, _ = _eval_both(monkeypatch, name, loss_impl)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_training_with_spec_augment_raises_and_evaluation_matches_jax(monkeypatch):
    """A config with SpecAugment trains as JAX does: with JAX's masks
    replayed into the port (``test_torch_train_recipe.py``), the first
    step's loss and ``grad_norm`` agree to 1e-5 relative. Training without
    an augment generator raises rather than skip the augmentation;
    evaluation and serving do not augment, as in JAX."""
    from tests.test_torch_train_recipe import replayed_masks, spy_feature_keys

    cfg = {**CONFORMER_CFG, "speech_config": {**CONFORMER_CFG["speech_config"], "augmentation_config": SPEC_AUGMENT}}
    got, ref, trainer = _eval_both(monkeypatch, "conformer", "auto", cfg)
    np.testing.assert_allclose(got, ref, rtol=1e-5)

    jm, v, tm, arrs = _both("conformer", cfg)
    keys = []
    spy_feature_keys(monkeypatch, keys)
    state = jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, v), optax.adam(1e-3), jax.random.PRNGKey(0))
    _, ref_metrics = jax.jit(jtrainer.make_train_step(jm, optax.adam(1e-3)))(state, _jax_batch(arrs))
    masks = replayed_masks(tm, keys[0], tm.feature_extraction.get_nframes(torch.tensor(arrs[1]).long()).numpy())
    assert all((widths > 0).any() for _, widths in masks)
    for method, params in zip(tm.feature_extraction.augmentation.feature_augmentations, masks):
        monkeypatch.setattr(method, "draw", lambda x, lengths, generator, params=params: params)
    trainer = Trainer(tm, ADAM, device="cpu")
    _, metrics = trainer.train_step(trainer.init_state(), _torch_batch(arrs))
    np.testing.assert_allclose(float(metrics["loss"]), float(ref_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_metrics["grad_norm"]), rtol=1e-5)

    batch = _torch_batch(_batch(np.random.default_rng(12)))
    transducer = Conformer.from_config({**TINY_CFG, "speech_config": cfg["speech_config"]}, device="cpu")
    transducer.reset_parameters(torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="augment_generator"):
        transducer.forward_joint_inputs(batch.inputs, train=True)
    plain = Conformer.from_config(TINY_CFG, device="cpu")
    plain.load_state_dict(transducer.state_dict())
    with torch.no_grad():
        # inference does not augment, as in JAX
        torch.testing.assert_close(transducer(batch.inputs, train=False).logits, plain(batch.inputs, train=False).logits, rtol=0, atol=0)
        augmented = transducer.feature_extraction(batch.inputs.inputs, batch.inputs.inputs_length, train=True, augment_generator=torch.Generator())[0]
        assert not torch.equal(augmented, transducer.feature_extraction(batch.inputs.inputs, batch.inputs.inputs_length)[0])
