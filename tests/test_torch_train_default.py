"""The port's default training step (``loss_impl="auto"``: the fused
joint+loss) vs the JAX package's ``make_train_step`` with
``TFASR_LOSS_IMPL=auto`` (the fused joint+loss and DP kernels in Pallas
interpret mode), on the tiny Conformer-T, f32, dropout 0, the same weights
and BatchNorm statistics on both sides.

The checks and their tolerances are those of ``test_torch_train_slice.py``
(its module docstring): loss and ``grad_norm`` to 1e-5 relative, every
gradient, parameter and running statistic to 1e-4 of its tensor's largest
magnitude plus the floor for the gradients that are zero in exact
arithmetic, which both sides freeze for the 3 Adam steps.
"""

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tensorflowasr_tpu_torch.training.trainer import Trainer, make_train_step
from tests.test_torch_slice import TINY_CFG
from tests.test_torch_train_slice import (ADAM, _batch, _torch_batch, check_first_step_every_gradient, check_first_step_loss_and_grad_norm,
                                          check_k_adam_steps, run_both)


@pytest.fixture(scope="module")
def runs():
    return run_both("auto")


def test_default_step_first_loss_and_grad_norm_match_jax(runs):
    check_first_step_loss_and_grad_norm(runs)


def test_default_step_every_gradient_matches_jax(runs):
    check_first_step_every_gradient(runs)


def test_default_step_k_adam_steps_match_jax(runs):
    check_k_adam_steps(runs)


def test_default_and_xla_steps_agree():
    """The two configurations of the port compute one loss: the same first
    step's loss (1e-5 relative) and gradients (1e-4 of each tensor's scale,
    plus 1e-6 of the largest gradient)."""
    batch = _torch_batch(_batch(np.random.default_rng(11)))
    results = {}
    for impl in ("auto", "xla"):
        model = Conformer.from_config(TINY_CFG, device="cpu")
        model.reset_parameters(torch.Generator().manual_seed(12))
        trainer = Trainer(model, ADAM, device="cpu", loss_impl=impl)
        state = trainer.init_state(seed=0)
        _, metrics = trainer.train_step(state, batch)
        results[impl] = (float(metrics["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()})
    (la, ga), (lx, gx) = results["auto"], results["xla"]
    np.testing.assert_allclose(la, lx, rtol=1e-5)
    gmax = max(g.abs().max().item() for g in gx.values())
    for name, g in ga.items():
        err, scale = (g - gx[name]).abs().max().item(), gx[name].abs().max().item()
        assert err <= 1e-4 * scale + 1e-6 * gmax, f"{name}: {err} > 1e-4 x {scale} + 1e-6 x {gmax}"


def test_unported_loss_configurations_raise():
    """"pallas", and an unsupported joint under "auto" or "fused-joint", name
    the unported unfused Pallas loss (TPU kernel row 10); they never fall back
    to the plain DP. An unknown name is refused."""
    model = Conformer.from_config(TINY_CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="row 10"):
        make_train_step(model, loss_impl="pallas")
    with pytest.raises(ValueError, match="loss_impl"):
        make_train_step(model, loss_impl="fused")
    for joint in ({"joint_mode": "mul"}, {"joint_activation": "relu"}, {"prejoint_prediction_linear": False}):
        other = Conformer.from_config({**TINY_CFG, **joint}, device="cpu")
        for impl in ("auto", "fused-joint"):
            with pytest.raises(NotImplementedError, match="row 10"):
                Trainer(other, ADAM, device="cpu", loss_impl=impl)
        Trainer(other, ADAM, device="cpu", loss_impl="xla")
