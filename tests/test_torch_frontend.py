"""Port frontend (plain log-mel chain, kernel arithmetic, FeatureExtraction)
vs the JAX frontend and its Pallas kernels (interpret mode), f32.

Both sides compute |FFT|² in f32 (rfft or direct DFT) before a log, so the
tolerance is 1e-3 absolute in log-mel, as the JAX kernel tests use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.models.layers.feature_extraction import FeatureExtraction as JFeatureExtraction
from tensorflowasr_tpu.ops import frontend as jfrontend
from tensorflowasr_tpu.ops.pallas import frontend_kernel as jfk
from tensorflowasr_tpu.utils import math_util as jmath
from tensorflowasr_tpu_torch.models.layers.feature_extraction import FeatureExtraction
from tensorflowasr_tpu_torch.ops import frontend
from tensorflowasr_tpu_torch.ops.cuda import frontend_kernel as fk
from tensorflowasr_tpu_torch.utils import math_util
from tensorflowasr_tpu_torch.utils.tracing import launches

LOG_TOL = dict(rtol=0, atol=1e-3)
SHAPES = [(2, 16000), (1, 16123), (3, 4000)]


def _signal(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_log_mel_matches_jax_xla(shape):
    sig = _signal(shape)
    ref = jfrontend.log_mel_spectrogram(jnp.asarray(sig), jfrontend.FrontendConfig())
    got = frontend.log_mel_spectrogram(torch.tensor(sig), frontend.FrontendConfig())
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOG_TOL)


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_plain_version_matches_pallas(version, shape):
    sig = _signal(shape, seed=1)
    jfn = jfk.log_mel_spectrogram_pallas if version == "v1" else jfk.log_mel_spectrogram_pallas_v2
    ref = jfn(jnp.asarray(sig), jfrontend.FrontendConfig(), interpret=True)
    got = fk.log_mel_spectrogram_pallas(torch.tensor(sig), frontend.FrontendConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOG_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_arithmetic_matches_plain(shape):
    """The CUDA kernel's arithmetic in numpy: index-arithmetic framing
    (pad_end, zero past N), the host-built windowed DFT bases, power, mel,
    log — against the rfft plain version."""
    cfg = frontend.FrontendConfig()
    sig = _signal(shape, seed=2).astype(np.float64)
    b, n = sig.shape
    t = cfg.get_nframes(n)
    idx = np.arange(t)[:, None] * cfg.frame_step + np.arange(cfg.frame_length)[None, :]
    padded = np.pad(sig, ((0, 0), (0, idx.max() + 1 - n))) if idx.max() >= n else sig
    frames = padded[:, idx]  # [B, T, FL]
    cos_b, sin_b = fk._dft_bases(cfg.frame_length, cfg.fft_length)
    power = (frames @ cos_b) ** 2 + (frames @ sin_b) ** 2
    mel = frontend.linear_to_mel_weight_matrix(cfg.num_feature_bins, cos_b.shape[1], cfg.sample_rate)
    emulated = np.log(power @ mel + cfg.epsilon)
    ref = fk.log_mel_spectrogram_plain(torch.tensor(sig, dtype=torch.float32), cfg)
    np.testing.assert_allclose(emulated, ref.numpy(), **LOG_TOL)


def test_mel_matrix_matches_jax():
    np.testing.assert_allclose(frontend.linear_to_mel_weight_matrix(80, 257, 16000), jfrontend.linear_to_mel_weight_matrix(80, 257, 16000), rtol=0, atol=0)


SPEECH_CASES = {
    "flagship": dict(sample_rate=16000, frame_ms=25, stride_ms=10, nfft=512, num_feature_bins=80),
    "normalized": dict(num_feature_bins=40, normalize_signal=True, normalize_zscore=True, padding=100),
    "min_max_log10_no_pad_end": dict(num_feature_bins=40, normalize_min_max=True, log_base="10", pad_end=False),
    "librosa_stft": dict(num_feature_bins=40, use_librosa_like_stft=True),
}


@pytest.mark.parametrize("case", sorted(SPEECH_CASES))
def test_feature_extraction_matches_jax(case):
    speech = SPEECH_CASES[case]
    sig = _signal((2, 8123), seed=3)
    lens = np.array([8123, 5000], np.int32)
    jmod = JFeatureExtraction(**speech)
    ref, ref_len = jmod.apply({}, jnp.asarray(sig), jnp.asarray(lens))
    got, got_len = FeatureExtraction(**speech)(torch.tensor(sig), torch.tensor(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOG_TOL)


def test_math_util_matches_jax():
    lens = np.array([0, 1, 159, 160, 16123])
    for pad_end in (True, False):
        np.testing.assert_array_equal(math_util.get_nframes(torch.tensor(lens), 400, 160, pad_end).numpy(), np.asarray(jmath.get_nframes(jnp.asarray(lens), 400, 160, pad_end)))
    for padding in ("same", "valid", "full", "causal"):
        for stride in (1, 2):
            assert math_util.conv_output_length(101, 3, padding, stride) == jmath.conv_output_length(101, 3, padding, stride)
    assert math_util.get_reduced_length(101, 4) == jmath.get_reduced_length(101, 4)
    np.testing.assert_array_equal(math_util.sequence_mask(torch.tensor([0, 3, 5]), 5).numpy(), np.asarray(jmath.sequence_mask(jnp.asarray([0, 3, 5]), 5)))
    x = np.arange(24).reshape(2, 3, 4)
    np.testing.assert_array_equal(math_util.merge_two_last_dims(torch.tensor(x)).numpy(), np.asarray(jmath.merge_two_last_dims(jnp.asarray(x))))


def test_wrapper_cpu_dispatch_and_unsupported_config():
    before = launches["kernel.frontend"]
    sig = torch.tensor(_signal((1, 3200)))
    torch.testing.assert_close(fk.log_mel_spectrogram_pallas(sig, frontend.FrontendConfig()), frontend.log_mel_spectrogram(sig, frontend.FrontendConfig()))
    assert launches["kernel.frontend"] == before
    with pytest.raises(ValueError, match="pad_end"):
        fk.log_mel_spectrogram_pallas(sig, frontend.FrontendConfig(log_base="10"))
    # mfcc, which raised until the port took it, builds and matches JAX's chain
    cfg = frontend.FrontendConfig(feature_type="mfcc")
    ref = jfrontend.extract_features(jnp.asarray(sig.numpy()), jnp.asarray([3200]), jfrontend.FrontendConfig(feature_type="mfcc"))[0]
    np.testing.assert_allclose(frontend.extract_features(sig, torch.tensor([3200]), cfg)[0].numpy(), np.asarray(ref), **LOG_TOL)
