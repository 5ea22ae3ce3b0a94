"""The RNN Transducer vs the JAX package, on the CPU, at f32, with the
checks of ``test_torch_transducer_transformer.py`` (its module docstring):
forward, greedy tokens (fused plain and eager WIND), the ``auto`` and
``xla`` steps with every gradient and 3 Adam steps, the eval step, and the
published config at full width; and the chunk loop.

The tiny model keeps the published layout's parts: 3 LSTM-16 blocks with
LayerNorm and a projection to 16, a post reduction ×3, a pre reduction ×2
(one of each kind; the published small config has post [3, 0, 2, 0]), an
LSTM-16 prediction net. Its features are z-scored (``normalize_zscore``):
on raw log-mel the first LSTM's gates saturate, and 5.6% of its weights
then have gradients below 1e-6 of the largest (f32 noise, which Adam turns
into steps of ~lr), more than the 1% that ``check_k_adam_steps`` exempts.
The LSTMs run JAX's default scan on both sides
(``rnn_impl="auto"``, the port's default on the CPU); under ``"pallas"``
(the default on the card) the forward and the eval step are held to JAX
under ``TFASR_RNN_IMPL=pallas``.

Streaming: 4 chunks of 16 frames (160 ms; not a multiple of the ×6
reduction, so each chunk pads under both reductions) through both
``recognize``s, each block's ``(c, h)`` and the prediction net's state
carried: every chunk's tokens, next tokens, encoder and decoder states
(2e-5) against JAX's chunk loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.models.transducer import base as jbase
from tensorflowasr_tpu.models.transducer.rnnt import RnnTransducer as JRnnTransducer
from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.models.encoders.rnnt import RnnTransducerEncoder
from tensorflowasr_tpu_torch.models.layers.rnn import RNN
from tensorflowasr_tpu_torch.models.layers.subsampling import TimeReduction
from tensorflowasr_tpu_torch.models.transducer import base as tbase
from tensorflowasr_tpu_torch.models.transducer.rnnt import RnnTransducer
from tensorflowasr_tpu_torch.ops import frontend
from tests.test_torch_train_slice import check_first_step_every_gradient, check_first_step_loss_and_grad_norm, check_k_adam_steps, run_both
from tests.test_torch_transducer_transformer import _HEAD, _SPEECH, check_forward_and_decodes, check_published_widths, eval_both, family_pair

TINY = {
    "speech_config": {**_SPEECH, "normalize_zscore": True},
    "encoder_reduction_positions": ["post", "pre", "post"], "encoder_reduction_factors": [3, 2, 0], "encoder_dmodel": 16,
    "encoder_rnn_type": "lstm", "encoder_rnn_units": 16, "encoder_nlayers": 3, "encoder_layer_norm": True,
    **_HEAD,
}


def test_time_reduction_pads_and_stacks_frames():
    x = torch.arange(2 * 7 * 3, dtype=torch.float32).reshape(2, 7, 3)
    y, lens = TimeReduction(3)(x, torch.tensor([7, 4]))
    assert y.shape == (2, 3, 9) and lens.tolist() == [3, 2]
    assert torch.equal(y[:, 0], x[:, :3].reshape(2, 9)) and torch.equal(y[:, 2, :3], x[:, 6]) and not y[:, 2, 3:].any()


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_rnnt_forward_and_decodes_match_jax(monkeypatch, impl):
    monkeypatch.setenv("TFASR_RNN_IMPL", impl)
    check_forward_and_decodes(*family_pair(JRnnTransducer, RnnTransducer, TINY, rnn_impl=impl))


@pytest.fixture(scope="module", params=["auto", "xla"])
def runs(request):
    return run_both(request.param, cfg=TINY, jax_cls=JRnnTransducer, port_cls=RnnTransducer)


def test_rnnt_step_loss_and_grad_norm_match_jax(runs):
    check_first_step_loss_and_grad_norm(runs)


def test_rnnt_step_every_gradient_matches_jax(runs):
    check_first_step_every_gradient(runs)


def test_rnnt_k_adam_steps_match_jax(runs):
    check_k_adam_steps(runs)


def test_rnnt_eval_step_matches_jax(monkeypatch):
    got, ref = eval_both(JRnnTransducer, RnnTransducer, TINY, "auto", monkeypatch)
    assert abs(got - ref) <= 1e-5 * abs(ref)


def test_rnnt_streams_through_recognize_as_jax():
    jm, v, tm, _ = family_pair(JRnnTransducer, RnnTransducer, TINY, seed=5)
    tm.eval()
    cfg = frontend.FrontendConfig(**_SPEECH)
    size, step = cfg.get_signal_chunk_size_and_step(16)
    sig = (np.random.default_rng(7).standard_normal((1, 3 * step + size)) * 0.5).astype(np.float32)
    jtok, jenc, jdec = jnp.zeros((1,), jnp.int32), jm.init_encoder_states(1), jm.init_decoder_states(1)
    ttok, tenc, tdec = None, tm.init_encoder_states(1), None
    assert len(tenc) == 3 and all(c.shape == (1, 16) for c, _ in tenc)
    jchunk = jax.jit(lambda v_, p_: jbase.recognize(jm, v_, p_))
    emitted = 0
    for i in range(4):
        chunk, n = sig[:, i * step: i * step + size], np.array([size], np.int32)
        ref = jchunk(v, jschemas.PredictInput(jnp.asarray(chunk), jnp.asarray(n), jtok, jenc, jdec))
        got = tbase.recognize(tm, schemas.PredictInput(torch.tensor(chunk), torch.tensor(n), ttok, tenc, tdec))
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
        np.testing.assert_array_equal(got.next_tokens.numpy(), np.asarray(ref.next_tokens))
        for states, ref_states in ((got.next_encoder_states, ref.next_encoder_states), (got.next_decoder_states, ref.next_decoder_states)):
            g, r = jax.tree_util.tree_leaves(states), jax.tree_util.tree_leaves(ref_states)
            assert len(g) == len(r) > 0
            for a, b in zip(g, r):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)
        emitted += int((got.tokens != 0).sum())
        jtok, jenc, jdec = ref.next_tokens, ref.next_encoder_states, ref.next_decoder_states
        ttok, tenc, tdec = got.next_tokens, got.next_encoder_states, got.next_decoder_states
    assert emitted > 0


@pytest.mark.parametrize("device, impl", [("cpu", "auto"), (None, "pallas")])
def test_rnnt_default_lstm_route_follows_the_build_device(device, impl, monkeypatch):
    """Without ``rnn_impl`` every LSTM (the encoder's and the prediction
    net's) takes the kernels on the card and JAX's scan on the CPU."""
    if device is None:  # no card here: build on the CPU as if for one, to read the route
        monkeypatch.setattr("tensorflowasr_tpu_torch.models.transducer.rnnt.default_rnn_impl", lambda _: "pallas")
        model = RnnTransducer.from_config(TINY, device="cpu")
    else:
        model = RnnTransducer.from_config(TINY, device=device)
    assert model.rnn_impl == impl and {m.rnn_impl for m in model.modules() if isinstance(m, RNN)} == {impl}


def test_rnnt_builds_at_published_widths(tmp_path):
    model = check_published_widths("examples/models/transducer/rnnt/small.yml.j2", RnnTransducer, tmp_path)
    enc = model.encoder
    assert isinstance(enc, RnnTransducerEncoder) and enc.time_reduction_factor == 6
    widths = [getattr(enc, f"block_{i}").rnn.cell.weight_ih.shape[1] for i in range(4)]
    assert widths == [80, 960, 320, 640] and model.prediction.rnn_0.cell.units == 1024
    assert model.decode_params() is not None  # both prejoint linears: the fused decode takes it
