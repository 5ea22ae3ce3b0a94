"""The port's evaluation step, its ``pallas`` training step and a joint the
fused loss does not take, vs the JAX package, on the tiny Conformer-T at
f32, on the CPU.

- ``make_eval_step``: the default (``loss_impl="auto"``: the unfused Pallas
  loss, TPU kernel row 10) against JAX's ``make_eval_step`` under the
  default env, and ``"xla"`` (the plain DP) against JAX's under
  ``TFASR_LOSS_IMPL=xla``: the loss to 1e-5 relative, the same weights and
  BatchNorm statistics on both sides (``bridge.py``).
- The ``pallas`` training step with the fused LSTM (``loss_impl="pallas"``,
  ``rnn_impl="pallas"``) against JAX's ``make_train_step`` under
  ``TFASR_LOSS_IMPL=pallas`` and ``TFASR_RNN_IMPL=pallas``, and a ``mul``
  joint under ``auto`` (which both sides train through row 10), with the
  checks and tolerances of ``test_torch_train_slice.py`` (its module
  docstring): loss and ``grad_norm`` to 1e-5 relative, every gradient and,
  after 3 Adam steps, every parameter and running statistic to 1e-4 of its
  tensor's largest magnitude plus the floor for the gradients that are zero
  in exact arithmetic. JAX's kernels run in Pallas interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu.training import trainer as jtrainer
from tensorflowasr_tpu_torch import bridge
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tensorflowasr_tpu_torch.training.trainer import Trainer
from tests.test_torch_slice import TINY_CFG
from tests.test_torch_train_slice import (ADAM, _batch, _jax_batch, _torch_batch, check_first_step_every_gradient, check_first_step_loss_and_grad_norm,
                                          check_k_adam_steps, run_both)


def _eval_both(monkeypatch, loss_impl: str):
    """One eval batch through JAX ``make_eval_step`` (with ``TFASR_LOSS_IMPL``
    unset for the default) and the port's ``Trainer.eval_step``."""
    if loss_impl == "auto":
        monkeypatch.delenv("TFASR_LOSS_IMPL", raising=False)
    else:
        monkeypatch.setenv("TFASR_LOSS_IMPL", loss_impl)
    rng = np.random.default_rng(21)
    arrs = _batch(rng)
    jm = JConformer.from_config(TINY_CFG)
    jb = _jax_batch(arrs)
    v = jax.tree_util.tree_map(np.asarray, jm.init({"params": jax.random.PRNGKey(2)}, jb.inputs, train=False))
    v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    state = jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, v), optax.adam(1e-3), jax.random.PRNGKey(0))
    ref = float(jtrainer.make_eval_step(jm)(state, jb)["loss"])
    tm = Conformer.from_config(TINY_CFG, device="cpu")
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    trainer = Trainer(tm, ADAM, device="cpu", loss_impl=loss_impl)
    got = trainer.eval_step(trainer.init_state(), _torch_batch(arrs))["loss"]
    return float(got), ref


@pytest.mark.parametrize("loss_impl", ["auto", "xla"])
def test_eval_step_matches_jax(monkeypatch, loss_impl):
    got, ref = _eval_both(monkeypatch, loss_impl)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_eval_default_and_xla_agree():
    """The port's two eval losses (kernels' plain versions vs the autograd DP) are one loss."""
    batch = _torch_batch(_batch(np.random.default_rng(22)))
    model = Conformer.from_config(TINY_CFG, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(23))
    losses = {}
    for impl in ("auto", "pallas", "xla"):
        trainer = Trainer(model, ADAM, device="cpu", loss_impl=impl)
        losses[impl] = float(trainer.eval_step(trainer.init_state(), batch)["loss"])
    np.testing.assert_allclose(losses["auto"], losses["xla"], rtol=1e-5)
    assert losses["auto"] == losses["pallas"]


@pytest.fixture(scope="module")
def pallas_runs():
    return run_both("pallas", rnn_impl="pallas")


def test_pallas_step_first_loss_and_grad_norm_match_jax(pallas_runs):
    check_first_step_loss_and_grad_norm(pallas_runs)


def test_pallas_step_every_gradient_matches_jax(pallas_runs):
    check_first_step_every_gradient(pallas_runs)


def test_pallas_step_k_adam_steps_match_jax(pallas_runs):
    check_k_adam_steps(pallas_runs)


@pytest.fixture(scope="module")
def mul_joint_runs():
    return run_both("auto", cfg={**TINY_CFG, "joint_mode": "mul"})


def test_mul_joint_auto_step_first_loss_and_grad_norm_match_jax(mul_joint_runs):
    check_first_step_loss_and_grad_norm(mul_joint_runs)


def test_mul_joint_auto_step_every_gradient_matches_jax(mul_joint_runs):
    check_first_step_every_gradient(mul_joint_runs)


def test_mul_joint_auto_step_k_adam_steps_match_jax(mul_joint_runs):
    check_k_adam_steps(mul_joint_runs)
