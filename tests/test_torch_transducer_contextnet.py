"""The ContextNet Transducer vs the JAX package, on the CPU, at f32, with
the checks of ``test_torch_transducer_transformer.py`` (its module
docstring): forward, BatchNorm statistics, greedy tokens (fused plain and
eager WIND), the ``auto`` and ``xla`` steps with every gradient and 3 Adam
steps, the BatchNorm statistics back to flax, the eval step, and the
published config at full width.

The tiny model keeps what makes ContextNet: α 0.5 over filters 32 / 32 /
48, kernel 5, causal separable convs, a strided block with a residual (its
linear ``ConvModule`` on the block's input and lengths), a block of two
modules, the SE in every block (``fc1`` a width // 8 of the scaled width),
and padding frames left in every BatchNorm's statistics, as flax has them.
The pointwise convs' biases precede a BatchNorm, so their gradient is zero
in exact arithmetic; both sides freeze them (``FROZEN``)."""

import pytest

from tensorflowasr_tpu.models.transducer.contextnet import ContextNet as JContextNet
from tensorflowasr_tpu_torch.models.encoders.contextnet import ContextNetEncoder
from tensorflowasr_tpu_torch.models.transducer.contextnet import ContextNet
from tests.test_torch_train_slice import check_first_step_every_gradient, check_first_step_loss_and_grad_norm, check_k_adam_steps, run_both
from tests.test_torch_transducer_transformer import (_HEAD, _SPEECH, check_batch_stats_round_trip, check_forward_and_decodes, check_published_widths,
                                                     eval_both, family_pair)

_BLOCK = {"kernel_size": 5, "activation": "silu", "padding": "causal"}
TINY = {
    "speech_config": _SPEECH,
    "encoder_alpha": 0.5,
    "encoder_blocks": [{**_BLOCK, "nlayers": 1, "filters": 32, "strides": 1, "residual": False},
                       {**_BLOCK, "nlayers": 2, "filters": 32, "strides": 2, "residual": True},
                       {**_BLOCK, "nlayers": 1, "filters": 48, "strides": 1, "residual": False}],
    **_HEAD,
}


def test_contextnet_forward_and_decodes_match_jax():
    check_forward_and_decodes(*family_pair(JContextNet, ContextNet, TINY))


@pytest.fixture(scope="module", params=["auto", "xla"])
def runs(request):
    return run_both(request.param, cfg=TINY, jax_cls=JContextNet, port_cls=ContextNet)


def test_contextnet_step_loss_and_grad_norm_match_jax(runs):
    check_first_step_loss_and_grad_norm(runs)


def test_contextnet_step_every_gradient_matches_jax(runs):
    check_first_step_every_gradient(runs)


def test_contextnet_k_adam_steps_and_batch_stats_match_jax(runs):
    check_k_adam_steps(runs)
    check_batch_stats_round_trip(runs)


def test_contextnet_eval_step_matches_jax(monkeypatch):
    got, ref = eval_both(JContextNet, ContextNet, TINY, "auto", monkeypatch)
    assert abs(got - ref) <= 1e-5 * abs(ref)


def test_contextnet_builds_at_published_widths(tmp_path):
    model = check_published_widths("examples/models/transducer/contextnet/small.yml.j2", ContextNet, tmp_path)
    enc = model.encoder
    assert isinstance(enc, ContextNetEncoder) and len(enc.blocks) == 23 and enc.dmodel == 320 and enc.time_reduction_factor == 8
    assert enc.block_1.se.fc1.weight.shape == (16, 128) and enc.init_state(2) is None
    assert model.decode_params() is not None
