"""The rest of the CTC family vs the JAX package, on the CPU, at f32 with
dropout 0: the spectrogram and base-10 log-mel frontends, the
bidirectional LSTM layer, DeepSpeech2 and Jasper.

- Features: ``extract_features`` (and the model's ``FeatureExtraction``) to
  1e-4 in the log domain (two FFT libraries).
- The bidirectional ``RNN`` against JAX's ``RNN(bidirectional=True)`` with
  ragged lengths (a full row, two shorter ones): under ``auto`` the outputs
  on every frame and both carries to 1e-5; under ``pallas`` (the LSTM
  kernels' plain version for each direction, the flip a gather around it)
  the outputs on the valid frames and 0 past each length; the gradients of
  the input and every weight to 1e-4 of their largest magnitude.
- Tiny DeepSpeech2 (2 conv blocks of 4 filters at kernels (11, 41) and (11,
  21), strides (2, 2) and (1, 2), 2 LSTM layers, 1 FC layer) in the base
  layout (bidirectional, ``same`` convs) and the uni layout (causal convs,
  RowConv 3), and tiny Jasper (dense and not, a dilated second block): the
  eval forward's logits to 1e-4 of their largest magnitude and greedy tokens
  equal; the train forward with the BatchNorm statistics it updates; the
  ``xla`` training step (the CTC loss's plain α recursion) with every
  gradient and 3 Adam steps, with the checks of ``test_torch_train_slice.py``.
  The uni layout runs the LSTM kernels' route (``rnn_impl="pallas"``) held
  to JAX under ``TFASR_RNN_IMPL=pallas`` (its fused path also writes zeros
  past each length, which RowConv's BatchNorm reads), and streams 3 chunks
  through ``recognize`` with the carried LSTM states, held to JAX chunk by
  chunk (logits, tokens and states to 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.models.ctc import base as jbase
from tensorflowasr_tpu.models.ctc.deepspeech2 import DeepSpeech2 as JDeepSpeech2
from tensorflowasr_tpu.models.ctc.jasper import Jasper as JJasper
from tensorflowasr_tpu.models.layers.rnn import RNN as JRNN
from tensorflowasr_tpu.ops import frontend as jfrontend
from tensorflowasr_tpu_torch import bridge, schemas
from tensorflowasr_tpu_torch.models.ctc.base import recognize
from tensorflowasr_tpu_torch.models.ctc.deepspeech2 import DeepSpeech2, default_rnn_impl
from tensorflowasr_tpu_torch.models.ctc.jasper import Jasper
from tensorflowasr_tpu_torch.models.layers.feature_extraction import FeatureExtraction
from tensorflowasr_tpu_torch.models.layers.rnn import RNN
from tensorflowasr_tpu_torch.ops import frontend
from tests.test_torch_train_slice import (_batch, _jax_batch, _torch_batch, check_first_step_every_gradient, check_first_step_loss_and_grad_norm,
                                          check_k_adam_steps, run_both)


def _scaled(got, ref, rel, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(initial=0.0), np.abs(ref).max(initial=0.0)
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


# ------------------------------- features --------------------------------- #

FEATURES = {
    "spectrogram_160": dict(num_feature_bins=160, feature_type="spectrogram"),
    "log10_mel": dict(num_feature_bins=80, log_base="10"),
    "spectrogram_min_max": dict(num_feature_bins=40, feature_type="spectrogram", normalize_min_max=True, log_base="10"),
}


@pytest.mark.parametrize("case", sorted(FEATURES))
def test_features_match_jax(case):
    kw = dict(sample_rate=16000, frame_ms=25, stride_ms=10, nfft=512, **FEATURES[case])
    sig = (np.random.default_rng(1).standard_normal((2, 5123)) * 0.3).astype(np.float32)
    lens = np.array([5123, 3000], np.int32)
    ref, ref_len = jfrontend.extract_features(jnp.asarray(sig), jnp.asarray(lens), jfrontend.FrontendConfig(**kw))
    got, got_len = frontend.extract_features(torch.tensor(sig), torch.tensor(lens), frontend.FrontendConfig(**kw))
    assert got.shape == ref.shape and got.shape[-1] == kw["num_feature_bins"]
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    mod, _ = FeatureExtraction(**kw)(torch.tensor(sig), torch.tensor(lens))
    np.testing.assert_array_equal(mod.numpy(), got.numpy())


# ----------------------------- bidirectional ------------------------------ #


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_bidirectional_rnn_matches_jax(impl):
    b, t, e, u = 3, 11, 6, 5
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, t, e)).astype(np.float32)
    lengths = np.array([t, 7, 4], np.int32)
    valid = (np.arange(t)[None, :] < lengths[:, None])[..., None]
    w_y = rng.standard_normal((b, t, 2 * u)).astype(np.float32) * (valid if impl == "pallas" else 1.0)
    w_c = [rng.standard_normal((b, u)).astype(np.float32) for _ in range(4)]
    jr = JRNN(units=u, bidirectional=True)
    params = jr.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(lengths))["params"]
    params = jax.tree_util.tree_map(lambda a: a + 0.2 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32), params)  # nonzero biases

    def jloss(p, x_):
        y, ((cf, hf), (cb, hb)) = jr.apply({"params": p}, x_, jnp.asarray(lengths))
        return jnp.sum(y * w_y) + sum(jnp.sum(c * w) for c, w in zip((cf, hf, cb, hb), w_c)), (y, (cf, hf, cb, hb))

    (_, (jy, jcarry)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    rnn = RNN(e, u, bidirectional=True, rnn_impl=impl)
    rnn.load_state_dict(bridge.state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, params)}), strict=True)
    tx = torch.tensor(x, requires_grad=True)
    y, ((cf, hf), (cb, hb)) = rnn(tx, torch.tensor(lengths))
    carry = (cf, hf, cb, hb)
    for got, ref in zip(carry, jcarry):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    if impl == "auto":
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose((y.detach().numpy() * valid), np.asarray(jy) * valid, rtol=0, atol=1e-5)
        assert not y.detach().numpy()[~np.broadcast_to(valid, y.shape)].any()
    loss = (y * torch.tensor(w_y)).sum() + sum((c * torch.tensor(w)).sum() for c, w in zip(carry, w_c))
    loss.backward()
    _scaled(tx.grad.numpy(), np.asarray(jgx), 1e-4, "dx")
    ref = bridge.state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgp)})
    assert set(ref) == {name for name, _ in rnn.named_parameters()} and len(ref) == 6
    for name, p in rnn.named_parameters():
        _scaled(p.grad.numpy(), ref[name].numpy(), 1e-4, name)


# --------------------------- DeepSpeech2, Jasper --------------------------- #

_SPEECH = {"sample_rate": 16000, "frame_ms": 25, "stride_ms": 10, "nfft": 512, "num_feature_bins": 40}
DS2_BASE = {"speech_config": {**_SPEECH, "feature_type": "spectrogram"}, "conv_type": "conv2d", "conv_kernels": [[11, 41], [11, 21]],
            "conv_strides": [[2, 2], [1, 2]], "conv_filters": [4, 4], "conv_padding": "same", "conv_activation": "relu", "rnn_nlayers": 2,
            "rnn_type": "lstm", "rnn_units": 12, "rnn_bidirectional": True, "rnn_rowconv": 0, "rnn_dropout": 0.0, "fc_nlayers": 1,
            "fc_units": 16, "fc_activation": "relu", "fc_dropout": 0.0, "blank": 0, "vocab_size": 20}
DS2_UNI = {**DS2_BASE, "conv_padding": "causal", "rnn_units": 16, "rnn_bidirectional": False, "rnn_rowconv": 3, "rnn_rowconv_activation": "relu"}
_JASPER = {"speech_config": {**_SPEECH, "feature_type": "log_mel_spectrogram", "log_base": "10"}, "first_additional_block_channels": 8,
           "first_additional_block_kernels": 5, "first_additional_block_dropout": 0.0, "nsubblocks": 2, "block_channels": [8, 12, 12],
           "block_kernels": [3, 5, 3], "block_dropout": [0.0, 0.0, 0.0], "second_additional_block_channels": 16,
           "second_additional_block_kernels": 3, "second_additional_block_dropout": 0.0, "third_additional_block_channels": 16,
           "third_additional_block_dropout": 0.0, "blank": 0, "vocab_size": 20}
# name: (JAX class, port class, config, rnn_impl)
MODELS = {
    "ds2_base": (JDeepSpeech2, DeepSpeech2, DS2_BASE, "auto"),
    "ds2_uni": (JDeepSpeech2, DeepSpeech2, DS2_UNI, "pallas"),
    "jasper_dense": (JJasper, Jasper, {**_JASPER, "dense": True}, "auto"),
    "jasper": (JJasper, Jasper, {**_JASPER, "dense": False}, "auto"),
}


def _pair(name: str, monkeypatch, impl: str | None = None):
    """JAX model and variables (BatchNorm statistics moved off 0/1) and the
    port's model with them, for ``name``; JAX's ``TFASR_RNN_IMPL`` set to the
    port's ``rnn_impl`` (``impl``, else the model's)."""
    jcls, tcls, cfg, model_impl = MODELS[name]
    impl = impl or model_impl
    monkeypatch.setenv("TFASR_RNN_IMPL", impl)
    rng = np.random.default_rng(11)
    arrs = _batch(rng)
    jm = jcls.from_config(cfg)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(jax.random.PRNGKey(1), _jax_batch(arrs).inputs))
    v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    tm = tcls.from_config(cfg, device="cpu", **({"rnn_impl": impl} if tcls is DeepSpeech2 else {}))
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    return jm, v, tm, arrs


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_train_forward_and_greedy_tokens_match_jax(name, monkeypatch):
    jm, v, tm, arrs = _pair(name, monkeypatch)
    sig, lens = arrs[0], arrs[1]
    ref, ref_len, _ = jax.jit(lambda v_, s_, l_: jm.apply(v_, s_, l_, method=jm.encode))(v, jnp.asarray(sig), jnp.asarray(lens))
    tm.eval()
    with torch.inference_mode():
        got, got_len, _ = tm.encode(torch.tensor(sig), torch.tensor(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4 * np.abs(np.asarray(ref)).max())
    pin = jschemas.PredictInput(jnp.asarray(sig), jnp.asarray(lens), None, None, None)
    ref_tokens = jax.jit(lambda v_, p_: jbase.recognize(jm, v_, p_))(v, pin).tokens
    out = recognize(tm, schemas.PredictInput(torch.tensor(sig), torch.tensor(lens)))
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref_tokens))
    # the train forward: batch statistics, the running ones updated as flax does
    jb = _jax_batch(arrs)
    jout, updates = jax.jit(lambda v_, x_: jm.apply(v_, x_, train=True, mutable=["batch_stats"]))(v, jb.inputs)
    tout = tm(_torch_batch(arrs).inputs, train=True)
    np.testing.assert_allclose(tout.logits.detach().numpy(), np.asarray(jout.logits), rtol=0, atol=1e-4 * np.abs(np.asarray(jout.logits)).max())
    stats = bridge.state_dict_from_flax({"params": {}, "batch_stats": jax.tree_util.tree_map(np.asarray, updates["batch_stats"])})
    sd = tm.state_dict()
    assert stats
    for key, value in stats.items():
        np.testing.assert_allclose(sd[key].numpy(), value.numpy(), rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.fixture(scope="module", params=sorted(MODELS))
def runs(request):
    jcls, tcls, cfg, impl = MODELS[request.param]
    return run_both("xla", rnn_impl=impl, cfg=cfg, jax_cls=jcls, port_cls=tcls)


def test_train_step_loss_and_grad_norm_match_jax(runs):
    check_first_step_loss_and_grad_norm(runs)


def test_train_step_every_gradient_matches_jax(runs):
    check_first_step_every_gradient(runs)


def test_train_k_adam_steps_match_jax(runs):
    check_k_adam_steps(runs)


def test_uni_deepspeech2_streams_through_recognize_as_jax(monkeypatch):
    """3 chunks of 16 frames through both ``recognize``s, each layer's (c, h)
    carried: every chunk's logits, tokens and next states equal JAX's."""
    jm, v, tm, _ = _pair("ds2_uni", monkeypatch, impl="auto")  # the default route on both sides
    tm.eval()
    cfg = frontend.FrontendConfig(**DS2_UNI["speech_config"])
    size, step = cfg.get_signal_chunk_size_and_step(16)
    sig = (np.random.default_rng(7).standard_normal((1, 2 * step + size)) * 0.5).astype(np.float32)
    jstate, tstate = jm.init_encoder_states(1), tm.init_encoder_states(1)
    assert len(tstate) == 2 and all(s[0].shape == (1, 16) for s in tstate)
    jencode = jax.jit(lambda v_, s_, l_, st_: jm.apply(v_, s_, l_, st_, method=jm.encode))
    jrec = jax.jit(lambda v_, p_: jbase.recognize(jm, v_, p_))
    for i in range(3):
        chunk = sig[:, i * step: i * step + size]
        n = np.array([size], np.int32)
        ref, _, ref_state = jencode(v, jnp.asarray(chunk), jnp.asarray(n), jstate)
        ref_tokens = jrec(v, jschemas.PredictInput(jnp.asarray(chunk), jnp.asarray(n), None, jstate, None)).tokens
        with torch.inference_mode():
            got, _, got_state = tm.encode(torch.tensor(chunk), torch.tensor(n), initial_state=tstate)
        out = recognize(tm, schemas.PredictInput(torch.tensor(chunk), torch.tensor(n), None, tstate, None))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5 * max(1.0, np.abs(np.asarray(ref)).max()))
        np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref_tokens))
        for g, r in zip(jax.tree_util.tree_leaves(got_state), jax.tree_util.tree_leaves(ref_state)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)
        for g, r in zip(jax.tree_util.tree_leaves(out.next_encoder_states), jax.tree_util.tree_leaves(got_state)):
            np.testing.assert_array_equal(g.numpy(), r.numpy())
        jstate, tstate = ref_state, got_state


@pytest.mark.parametrize("device, impl", [("cpu", "auto"), ("cuda", "pallas"), ("cuda:0", "pallas"), (None, "pallas")])
def test_deepspeech2_default_lstm_route_follows_the_build_device(device, impl):
    """Without ``rnn_impl``, DeepSpeech2 takes the LSTM kernels when it is
    built for the card (``None`` or a CUDA device) and JAX's default scan on
    the CPU; a route that is asked for is kept."""
    assert default_rnn_impl(device) == impl
    model = DeepSpeech2.from_config(DS2_BASE, device="cpu")
    assert model.rnn_impl == "auto" and all(m.rnn_impl == "auto" for m in model.modules() if isinstance(m, RNN))
    model = DeepSpeech2.from_config(DS2_BASE, device="cpu", rnn_impl="pallas")
    assert model.rnn_impl == "pallas" and all(m.rnn_impl == "pallas" for m in model.modules() if isinstance(m, RNN))
