"""The layers the port took last, against the JAX package's, on the CPU.

Weights cross through ``bridge.py``; inputs come from a numpy seed. Each
module's forward is held at f32 1e-5 (summation order on unit-scale
outputs) and, where it trains, every gradient at 1e-4 of that gradient's
largest magnitude plus 1e-6 of the module's largest gradient (a gradient
that is zero in exact arithmetic, a conv bias ahead of BatchNorm on batch
statistics, is f32 noise; ``tests/test_torch_train_slice.py`` holds it
so), under one random cotangent:

- the GRU and the simple RNN (``models/layers/rnn.py``), unidirectional
  and bidirectional over ragged lengths, with carries passed in and out,
  and ``step`` against the scan;
- ``OneHotBlank``; ``Conv1dSubsampling`` and ``VggSubsampling`` (outputs
  and lengths, BatchNorm on batch statistics where it has one);
  ``DepthwiseConv2D``; ``BlurPool1D`` and ``BlurPool2D`` in every padding;
  ``SequenceBatchNorm`` with and without lengths;
- the MFCC and log-gammatone features, and the log-mel chain at nfft below
  the frame length (nfft 256 and 300 at 25 ms frames of 400 samples),
  against JAX's XLA ``extract_features``. Log features are held at 1e-3
  absolute, as ``tests/test_torch_frontend.py`` holds the log-mel chain
  (the two FFT libraries round differently where the power is small);
  the kernels' crop of a frame to nfft, emulated in f32, against a
  float64 rfft of the cropped frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.models.layers import blurpool as jblur
from tensorflowasr_tpu.models.layers import convolution as jconv
from tensorflowasr_tpu.models.layers import embedding as jemb
from tensorflowasr_tpu.models.layers import rnn as jrnn
from tensorflowasr_tpu.models.layers import sequence_bn as jsbn
from tensorflowasr_tpu.models.layers import subsampling as jsub
from tensorflowasr_tpu.ops import frontend as jfrontend
from tensorflowasr_tpu_torch import bridge
from tensorflowasr_tpu_torch.models.layers import blurpool as tblur
from tensorflowasr_tpu_torch.models.layers import convolution as tconv
from tensorflowasr_tpu_torch.models.layers import embedding as temb
from tensorflowasr_tpu_torch.models.layers import rnn as trnn
from tensorflowasr_tpu_torch.models.layers import sequence_bn as tsbn
from tensorflowasr_tpu_torch.models.layers import subsampling as tsub
from tensorflowasr_tpu_torch.ops import frontend
from tensorflowasr_tpu_torch.ops.cuda import frontend_kernel as fek

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
LOG_TOL = dict(rtol=0, atol=1e-3)


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _init(module, *args, seed=0, **kwargs):
    """JAX variables as numpy, parameters moved off their init values."""
    v = jax.tree_util.tree_map(np.asarray, module.init({"params": jax.random.PRNGKey(seed)}, *args, **kwargs))
    rng = np.random.default_rng(seed)
    if "params" in v:
        v["params"] = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), v["params"])
    return v


def _load(module, variables):
    module.load_state_dict(bridge.state_dict_from_flax(variables), strict=True)
    return module


def _hold_grads(tmod, jgrads: dict) -> None:
    """Every parameter's gradient (JAX's through the bridge) within GRAD_REL of its scale."""
    got_grads = {n: p.grad for n, p in tmod.named_parameters()}
    ref = bridge.state_dict_from_flax({"params": jgrads})
    names = {n for n, _ in tmod.named_parameters()}
    assert names <= set(ref)
    gmax = max(np.abs(ref[n].numpy()).max() for n in names)
    for name in names:
        r = ref[name].numpy()
        np.testing.assert_allclose(got_grads[name].numpy(), r, rtol=0, atol=GRAD_REL * np.abs(r).max() + 1e-6 * gmax, err_msg=name)


# ---------------------------------- GRU and simple RNN ---------------------------------- #


def _carry(rnn_type, b, u, seed):
    """A nonzero carry in the cell's structure: LSTM (c, h), GRU h, simple RNN (h,)."""
    h = _x((b, u), seed, 0.5)
    return h if rnn_type == "gru" else (h,)


@pytest.mark.parametrize("rnn_type", ["gru", "rnn"])
@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
def test_gru_and_simple_rnn_forward_carries_and_gradients(rnn_type, bidirectional):
    b, t, d, u = 3, 7, 5, 6
    x, lens = _x((b, t, d)), np.array([7, 4, 1], np.int32)
    init = _carry(rnn_type, b, u, 2)
    if bidirectional:
        init = (init, _carry(rnn_type, b, u, 3))
    jmod = jrnn.RNN(units=u, rnn_type=rnn_type, bidirectional=bidirectional)
    v = _init(jmod, jnp.asarray(x), jnp.asarray(lens))
    jinit = jax.tree_util.tree_map(jnp.asarray, init)
    (ref_y, ref_state) = jmod.apply(v, jnp.asarray(x), jnp.asarray(lens), jinit)
    tmod = _load(trnn.RNN(d, u, rnn_type, bidirectional=bidirectional), v)
    tx = torch.tensor(x, requires_grad=True)
    tinit = jax.tree_util.tree_map(torch.tensor, init)
    got_y, got_state = tmod(tx, torch.tensor(lens), tinit)
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(ref_y), **TOL)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, ref_state)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, got_state, is_leaf=torch.is_tensor))
    for g, r in zip(jax.tree_util.tree_leaves(got_state, is_leaf=torch.is_tensor), jax.tree_util.tree_leaves(ref_state)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **TOL)

    cot = _x(got_y.shape, 9)
    cot_h = [_x(np.asarray(r).shape, 10 + i) for i, r in enumerate(jax.tree_util.tree_leaves(ref_state))]

    def jloss(params, xx):
        y, state = jmod.apply({"params": params}, xx, jnp.asarray(lens), jinit)
        return jnp.sum(y * cot) + sum(jnp.sum(s * c) for s, c in zip(jax.tree_util.tree_leaves(state), cot_h))

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    loss = (got_y * torch.tensor(cot)).sum() + sum((s * torch.tensor(c)).sum()
                                                   for s, c in zip(jax.tree_util.tree_leaves(got_state, is_leaf=torch.is_tensor), cot_h))
    loss.backward()
    _hold_grads(tmod, jax.tree_util.tree_map(np.asarray, jg))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0, atol=GRAD_REL * np.abs(np.asarray(jgx)).max())


@pytest.mark.parametrize("rnn_type", ["gru", "rnn", "lstm"])
def test_rnn_step_equals_the_scan_and_jax_step(rnn_type):
    """``step`` from a passed carry, t steps, equals the scan's outputs and
    final carry and JAX's ``step``; ``init_state`` has JAX's structure."""
    b, t, d, u = 2, 5, 4, 6
    x = _x((b, t, d), 4)
    jmod = jrnn.RNN(units=u, rnn_type=rnn_type)
    v = _init(jmod, jnp.asarray(x))
    tmod = _load(trnn.RNN(d, u, rnn_type), v)
    jzero = jmod.apply(v, b, method=jrnn.RNN.init_state)
    tzero = tmod.init_state(b)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, jzero)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, tzero, is_leaf=torch.is_tensor))
    init = (_x((b, u), 5, 0.5), _x((b, u), 6, 0.5)) if rnn_type == "lstm" else _carry(rnn_type, b, u, 5)
    jstate, tstate = jax.tree_util.tree_map(jnp.asarray, init), jax.tree_util.tree_map(torch.tensor, init)
    scan_y, scan_state = tmod(torch.tensor(x), None, tstate)
    with torch.no_grad():
        for i in range(t):
            y, tstate = tmod.step(torch.tensor(x[:, i]), tstate)
            jy, jstate = jmod.apply(v, jnp.asarray(x[:, i]), jstate, method=jrnn.RNN.step)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
            np.testing.assert_allclose(y.numpy(), scan_y[:, i].detach().numpy(), **TOL)
    for g, r in zip(jax.tree_util.tree_leaves(tstate, is_leaf=torch.is_tensor), jax.tree_util.tree_leaves(scan_state, is_leaf=torch.is_tensor)):
        np.testing.assert_allclose(g.numpy(), r.detach().numpy(), **TOL)


# ------------------------------------- OneHotBlank -------------------------------------- #


@pytest.mark.parametrize("with_lengths", [False, True])
def test_one_hot_blank(with_lengths):
    tokens = np.array([[0, 3, 5, 2], [4, 0, 1, 1]], np.int32)
    lens = np.array([3, 4], np.int32) if with_lengths else None
    ref = jemb.OneHotBlank(vocab_size=6, blank=0).apply({}, jnp.asarray(tokens), None if lens is None else jnp.asarray(lens))
    got = temb.OneHotBlank(6, 0)(torch.tensor(tokens), None if lens is None else torch.tensor(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------- subsamplings ---------------------------------- #


def _train_apply(jmod, v, x, lens):
    (out, out_len), upd = jmod.apply(v, jnp.asarray(x), jnp.asarray(lens), train=True, mutable=["batch_stats"])
    return out, out_len, upd


SUBSAMPLINGS = {
    "conv1d_causal_batch": (jsub.Conv1dSubsampling, tsub.Conv1dSubsampling,
                            dict(filters=(8, 6), strides=(2, 2), kernels=(3, 3), paddings=("causal", "causal"), norms=("batch", "batch"),
                                 activations=("swish", "swish"))),
    "conv1d_same_layer": (jsub.Conv1dSubsampling, tsub.Conv1dSubsampling,
                          dict(filters=(7,), strides=(3,), kernels=(5,), paddings=("same",), norms=("layer",), activations=("relu",))),
    "vgg": (jsub.VggSubsampling, tsub.VggSubsampling, dict(filters=(4, 6), kernel_size=3, pool_size=2, strides=2)),
    "vgg_pool3": (jsub.VggSubsampling, tsub.VggSubsampling, dict(filters=(3, 5), kernel_size=3, pool_size=3, strides=2, activation="swish")),
}


@pytest.mark.parametrize("case", sorted(SUBSAMPLINGS))
def test_conv1d_and_vgg_subsampling_outputs_lengths_and_gradients(case):
    jcls, tcls, kw = SUBSAMPLINGS[case]
    freq = 11
    x, lens = _x((2, 17, freq, 1)), np.array([17, 9], np.int32)
    jmod = jcls(**kw)
    v = _init(jmod, jnp.asarray(x), jnp.asarray(lens))
    tmod = _load(tcls(freq, **kw), v)
    ref, ref_len = jmod.apply(v, jnp.asarray(x), jnp.asarray(lens))
    got, got_len = tmod(torch.tensor(x), torch.tensor(lens))
    assert tmod.output_dim == ref.shape[-1] and tmod.time_reduction_factor == jmod.time_reduction_factor
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_array_equal(np.asarray(tmod.output_length(np.asarray(lens))), np.asarray(jmod.output_length(np.asarray(lens))))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)

    # the training forward (BatchNorm on batch statistics) and every gradient
    ref_t, _, upd = _train_apply(jmod, v, x, lens)
    cot = _x(np.asarray(ref_t).shape, 7)

    def jloss(params):
        out, _, _ = _train_apply(jmod, {**v, "params": params}, x, lens)
        return jnp.sum(out * cot)

    jg = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(v["params"]))
    got_t, _ = tmod(torch.tensor(x), torch.tensor(lens), train=True)
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(ref_t), **TOL)
    (got_t * torch.tensor(cot)).sum().backward()
    _hold_grads(tmod, jg)
    if "batch_stats" in upd:
        for key, val in bridge.state_dict_from_flax({"params": {}, "batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])}).items():
            np.testing.assert_allclose(tmod.state_dict()[key].numpy(), val.numpy(), **TOL)


@pytest.mark.parametrize("padding,strides,multiplier", [("same", (1, 1), 1), ("causal", (2, 1), 2), ("valid", (2, 2), 1)])
def test_depthwise_conv2d(padding, strides, multiplier):
    x = _x((2, 9, 8, 3))
    jmod = jconv.DepthwiseConv2D(kernel_size=(3, 2), strides=strides, padding=padding, depth_multiplier=multiplier)
    v = _init(jmod, jnp.asarray(x))
    tmod = _load(tconv.DepthwiseConv2D(3, (3, 2), strides, padding, depth_multiplier=multiplier), v)
    tx = torch.tensor(x, requires_grad=True)
    got = tmod(tx)
    ref = jmod.apply(v, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    cot = _x(got.shape, 3)
    jg, jgx = jax.grad(lambda p, xx: jnp.sum(jmod.apply({"params": p}, xx) * cot), argnums=(0, 1))(v["params"], jnp.asarray(x))
    (got * torch.tensor(cot)).sum().backward()
    _hold_grads(tmod, jax.tree_util.tree_map(np.asarray, jg))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0, atol=GRAD_REL * np.abs(np.asarray(jgx)).max())


@pytest.mark.parametrize("padding", ["reflect", "symmetric", "constant", "valid"])
@pytest.mark.parametrize("dims", [1, 2])
def test_blurpool(dims, padding):
    x = _x((2, 11, 3) if dims == 1 else (2, 9, 10, 3))
    for k, s in ((4, 2), (3, 1), (5, 3)):
        jmod = (jblur.BlurPool1D if dims == 1 else jblur.BlurPool2D)(kernel_size=k, strides=s, padding=padding)
        tmod = (tblur.BlurPool1D if dims == 1 else tblur.BlurPool2D)(k, s, padding)
        np.testing.assert_allclose(tmod(torch.tensor(x)).numpy(), np.asarray(jmod.apply({}, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("time_major,with_lengths", [(False, False), (False, True), (True, True)])
def test_sequence_batch_norm(time_major, with_lengths):
    x = _x((7, 3, 5) if time_major else (3, 7, 5), scale=2.0) + 0.5
    lens = np.array([7, 4, 1], np.int32) if with_lengths else None
    jmod = jsbn.SequenceBatchNorm(time_major=time_major)
    v = _init(jmod, jnp.asarray(x))
    tmod = _load(tsbn.SequenceBatchNorm(5, time_major=time_major), v)
    tx = torch.tensor(x, requires_grad=True)
    tl = None if lens is None else torch.tensor(lens)
    jl = None if lens is None else jnp.asarray(lens)
    got = tmod(tx, tl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jmod.apply(v, jnp.asarray(x), jl)), **TOL)
    cot = _x(x.shape, 4)
    jg, jgx = jax.grad(lambda p, xx: jnp.sum(jmod.apply({"params": p}, xx, jl) * cot), argnums=(0, 1))(v["params"], jnp.asarray(x))
    (got * torch.tensor(cot)).sum().backward()
    _hold_grads(tmod, jax.tree_util.tree_map(np.asarray, jg))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0, atol=GRAD_REL * np.abs(np.asarray(jgx)).max())


# ------------------------------------- features ------------------------------------- #


def _audio(shape=(2, 6000), seed=3):
    sig = _x(shape, seed, 0.1)
    lens = np.array([shape[1], shape[1] * 3 // 4], np.int32)
    sig[1, lens[1]:] = 0.0
    return sig, lens


@pytest.mark.parametrize("feature_type", ["mfcc", "log_gammatone_spectrogram"])
@pytest.mark.parametrize("kw", [dict(), dict(nfft=256), dict(nfft=400, normalize_min_max=True), dict(normalize_zscore=True, num_feature_bins=40)],
                         ids=["nfft512", "nfft256", "nfft400_minmax", "zscore_40"])
def test_mfcc_and_gammatone_features(feature_type, kw):
    sig, lens = _audio()
    ref, ref_len = jfrontend.extract_features(jnp.asarray(sig), jnp.asarray(lens), jfrontend.FrontendConfig(feature_type=feature_type, **kw))
    got, got_len = frontend.extract_features(torch.tensor(sig), torch.tensor(lens), frontend.FrontendConfig(feature_type=feature_type, **kw))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=LOG_TOL["atol"] * scale)


def test_filterbanks_and_dct_equal_jax():
    for nfft, bins, lo, hi in ((512, 80, 0.0, 8000.0), (256, 40, 50.0, 7600.0), (300, 64, 0.0, 8000.0)):
        np.testing.assert_allclose(frontend.gammatone_fft_weights(nfft, 16000, bins, 1.0, lo, hi, nfft // 2 + 1),
                                   jfrontend.gammatone_fft_weights(nfft, 16000, bins, 1.0, lo, hi, nfft // 2 + 1), rtol=1e-6, atol=0)
    x = _x((3, 4, 80), 8)
    np.testing.assert_allclose(frontend.dct_type2_ortho_scaled(torch.tensor(x)).numpy(), np.asarray(jfrontend.dct_type2_ortho_scaled(jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("nfft", [256, 300])
def test_log_mel_below_the_frame_length_equals_jax_xla(nfft):
    """The plain chain at nfft below the 400-sample frame crops each windowed frame, as JAX's XLA chain does."""
    sig, lens = _audio((2, 16123), 11)
    cfg = dict(nfft=nfft, frame_ms=25, stride_ms=10)
    ref, ref_len = jfrontend.extract_features(jnp.asarray(sig), jnp.asarray(lens), jfrontend.FrontendConfig(**cfg))
    got, got_len = frontend.extract_features(torch.tensor(sig), torch.tensor(lens), frontend.FrontendConfig(**cfg))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOG_TOL)


@pytest.mark.parametrize("nfft", [256, 300])
def test_kernels_crop_the_frame_to_nfft(nfft):
    """What both frontend kernels compute below the frame length, emulated
    in f32: the first ``kernel_frame_length`` samples of each pad_end frame
    against the DFT bases (nfft rows), the sparse mel stage, the log;
    against float64 ``rfft(frames, n=nfft)``. On the CPU the wrapper runs
    the plain chain and no longer refuses the config."""
    cfg = frontend.FrontendConfig(nfft=nfft)
    fl = fek.kernel_frame_length(cfg)
    cos_b, sin_b = fek._dft_bases(cfg.frame_length, nfft)
    assert fl == nfft and cos_b.shape == (nfft, nfft // 2 + 1)
    sig = frontend.preemphasis_signal(torch.tensor(_x((2, 4000), 12, 0.1)), cfg).numpy()
    n = sig.shape[1]
    t = cfg.get_nframes(n)
    idx = np.arange(t)[:, None] * cfg.frame_step + np.arange(cfg.frame_length)[None, :]
    frames = np.pad(sig, ((0, 0), (0, int(idx.max()) + 1 - n)))[:, idx]
    mel = frontend.linear_to_mel_weight_matrix(cfg.num_feature_bins, nfft // 2 + 1, cfg.sample_rate)
    crop = torch.tensor(frames[..., :fl])
    power = (crop @ torch.tensor(cos_b)) ** 2 + (crop @ torch.tensor(sin_b)) ** 2
    w, lo, off = fek.mel_ranges(mel)
    emulated = torch.stack([torch.log((power[..., lo[m]:lo[m] + off[m + 1] - off[m]] * torch.tensor(w[off[m]:off[m + 1]])).sum(-1) + cfg.epsilon)
                            for m in range(mel.shape[1])], dim=-1)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(cfg.frame_length) / cfg.frame_length)
    exact = np.log(np.abs(np.fft.rfft(frames * window, n=nfft, axis=-1)) ** 2 @ mel.astype(np.float64) + cfg.epsilon)
    np.testing.assert_allclose(emulated.numpy(), exact, **LOG_TOL)
    plain = fek.log_mel_spectrogram_pallas(torch.tensor(sig), cfg)
    np.testing.assert_allclose(plain.numpy(), exact, **LOG_TOL)
