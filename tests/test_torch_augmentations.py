"""The port's augmentations (``tensorflowasr_tpu_torch/augmentations/``) vs the
JAX package's, on the CPU.

JAX draws per example from split PRNG keys; the port draws the whole batch
from a CPU generator. So the parity tests replay JAX's per-example draws
(the same key splits as ``Augmentation._augment_batch`` and each method's
``augment``) and inject them into the port's ``apply``: the masks then
agree bit for bit, for every ``mask_value`` kind and for ``prob`` < 1
(the ``mean`` value itself to 1e-6, its summation order differs).
``GaussNoise`` takes JAX's noise and agrees within 1e-6 at unit scale.
The port's own draws are checked for range and frequency on fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.augmentations import Augmentation as JAugmentation
from tensorflowasr_tpu_torch.augmentations import Augmentation
from tensorflowasr_tpu_torch.augmentations.methods import FreqMasking, GaussNoise, TimeMasking

B, T, F = 5, 60, 20
LENGTHS = np.array([60, 41, 17, 1, 0], np.int32)


def _features(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, T, F)).astype(np.float32)


def _mask_draws(key, prob: float, num_masks: int, hi, size_cap):
    """One example's (starts, widths) as JAX's ``FreqMasking``/``TimeMasking``
    draw them: per mask, split(key, 4) → prob gate, width in [0, hi), capped
    at ``size_cap``, start in [0, max(size_cap − width, 1))."""
    starts, widths = [], []
    for _ in range(num_masks):
        kp, kw, k0, key = jax.random.split(key, 4)
        on = int(jax.random.uniform(kp) <= prob)
        w = on * min(int(jax.random.randint(kw, (), 0, hi)), size_cap)
        s = on * int(jax.random.randint(k0, (), 0, max(size_cap - w, 1)))
        starts.append(s)
        widths.append(w)
    return starts, widths


def _replay(method, keys, lengths) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, num_masks] (starts, widths) of ``method`` from per-example ``keys``."""
    rows = []
    for b, key in enumerate(keys):
        if isinstance(method, FreqMasking):
            rows.append(_mask_draws(key, method.prob, method.num_masks, max(method.mask_factor, 1), F))
        else:
            bound = int(np.floor(np.float32(lengths[b]) * np.float32(method.p_upperbound)))
            rows.append(_mask_draws(key, method.prob, method.num_masks, max(bound, 1), int(lengths[b])))
    starts = torch.tensor([r[0] for r in rows], dtype=torch.float64)
    widths = torch.tensor([r[1] for r in rows], dtype=torch.float64)
    return starts, widths


def _per_example_keys(key, n_methods: int):
    """Per method, the B per-example keys ``Augmentation._augment_batch`` gives it."""
    keys = jax.random.split(key, B)
    per = [jax.random.split(k, n_methods) for k in keys]
    return [[per[b][i] for b in range(B)] for i in range(n_methods)]


def _check(got: torch.Tensor, ref: np.ndarray, x: np.ndarray, mask_value):
    got = got.numpy()
    if mask_value == "mean":
        np.testing.assert_array_equal(got != x, ref != x)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)


MASK_VALUES = ["zero", "mean", "min", "max", 0, -2.5]
METHODS = {
    "freq_masking": lambda mv, prob: {"num_masks": 3, "mask_factor": 9, "prob": prob, "mask_value": mv},
    "time_masking": lambda mv, prob: {"num_masks": 4, "mask_factor": -1, "p_upperbound": 0.3, "prob": prob, "mask_value": mv},
}


@pytest.mark.parametrize("prob", [1.0, 0.5])
@pytest.mark.parametrize("mask_value", MASK_VALUES, ids=str)
@pytest.mark.parametrize("name", list(METHODS))
def test_masking_matches_jax(name, mask_value, prob):
    config = {"feature_augment": {name: METHODS[name](mask_value, prob)}}
    x = _features(1)
    key = jax.random.PRNGKey(7)
    ref, ref_len = JAugmentation(config).feature_augment(jnp.asarray(x), jnp.asarray(LENGTHS), key)
    port = Augmentation(config)
    (method,) = port.feature_augmentations
    params = _replay(method, _per_example_keys(key, 1)[0], LENGTHS)
    got = method.apply(torch.tensor(x), torch.tensor(LENGTHS, dtype=torch.int64), params)
    _check(got, np.asarray(ref), x, mask_value)
    np.testing.assert_array_equal(np.asarray(ref_len), LENGTHS)
    if prob == 1.0 and name == "freq_masking":
        assert (params[1] > 0).any()


@pytest.mark.parametrize("mask_value", ["mean", 0])
def test_augmentation_runs_methods_in_sorted_order(monkeypatch, mask_value):
    """freq_masking, then time_masking (whose mean is taken over the frequency-masked example)."""
    config = {"feature_augment": {name: make(mask_value, 1.0) for name, make in METHODS.items()}}
    x = _features(2)
    key = jax.random.PRNGKey(11)
    ref, _ = JAugmentation(config).feature_augment(jnp.asarray(x), jnp.asarray(LENGTHS), key)
    port = Augmentation(config)
    assert [type(m) for m in port.feature_augmentations] == [FreqMasking, TimeMasking]
    for method, keys in zip(port.feature_augmentations, _per_example_keys(key, 2)):
        params = _replay(method, keys, LENGTHS)
        monkeypatch.setattr(method, "draw", lambda x, lengths, generator, params=params: params)
    got, lengths = port.feature_augment(torch.tensor(x), torch.tensor(LENGTHS, dtype=torch.int64), torch.Generator())
    _check(got, np.asarray(ref), x, mask_value)
    assert lengths.tolist() == LENGTHS.tolist()


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_gauss_noise_matches_jax(prob):
    config = {"signal_augment": {"gauss_noise": {"mean": 0.1, "stddev": 0.5, "prob": prob}}}
    n = 400
    sig = np.random.default_rng(3).standard_normal((B, n)).astype(np.float32)
    lens = np.array([400, 250, 7, 1, 0], np.int32)
    key = jax.random.PRNGKey(5)
    ref, _ = JAugmentation(config).signal_augment(jnp.asarray(sig), jnp.asarray(lens), key)
    ons, noises = [], []
    for k in _per_example_keys(key, 1)[0]:
        kp, kn = jax.random.split(k)
        ons.append(float(jax.random.uniform(kp) <= prob))
        noises.append(np.asarray(0.1 + 0.5 * jax.random.normal(kn, (n,), jnp.float32)))
    (method,) = Augmentation(config).signal_augmentations
    got = method.apply(torch.tensor(sig), torch.tensor(lens, dtype=torch.int64), (torch.tensor(ons), torch.tensor(np.stack(noises))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    valid = np.arange(n)[None, :] < lens[:, None]
    np.testing.assert_array_equal(got.numpy()[~valid], sig[~valid])


def test_own_draws_range_and_frequency():
    """On fixed seeds: every width and start in its range, widths spread
    over [0, hi), the gate firing at ``prob``; the same seed draws the same."""
    rows = 4000
    x = torch.zeros(rows, 200, 80)
    lengths = torch.tensor(np.random.default_rng(0).integers(0, 201, rows))
    freq, time = FreqMasking(num_masks=2, mask_factor=27, prob=0.3), TimeMasking(num_masks=3, p_upperbound=0.05, prob=0.7)
    f0, f = freq.draw(x, lengths, torch.Generator().manual_seed(1))
    assert f.min() >= 0 and f.max() <= 26 and ((f0 >= 0) & (f0 + f <= 80)).all()
    on = f > 0
    assert abs(on.double().mean().item() - 0.3 * 26 / 27) < 0.02
    counts = torch.bincount(f[on].long(), minlength=27)[1:]
    assert counts.min() > 0.6 * counts.double().mean() and counts.max() < 1.4 * counts.double().mean()
    t0, t = time.draw(x, lengths, torch.Generator().manual_seed(2))
    hi = torch.clamp_min(torch.floor(lengths.float() * 0.05), 1)[:, None].double()
    assert (t >= 0).all() and (t < hi).all() and (t <= lengths[:, None]).all()
    assert ((t0 >= 0) & (t0 + t <= torch.clamp_min(lengths, 1)[:, None])).all()
    expected = 0.7 * ((hi.expand_as(t) - 1) / 2).mean().item()  # gated at 0.7, then uniform on [0, hi)
    assert abs(t.mean().item() - expected) < 0.03 * expected
    again = freq.draw(x, lengths, torch.Generator().manual_seed(1))
    assert torch.equal(again[0], f0) and torch.equal(again[1], f)


def test_unknown_augmentation_raises():
    with pytest.raises(KeyError, match="No augmentation named"):
        Augmentation({"feature_augment": {"pitch_shift": {}}})
    with pytest.raises(ValueError, match="mask_value"):
        FreqMasking(mask_value="median")


def test_gauss_noise_draws_on_the_tensor_device_from_the_cpu_stream():
    x, lens = torch.zeros(3, 1000), torch.tensor([1000, 500, 0])
    method = GaussNoise(stddev=1.0, prob=1.0)
    out = method(x, lens, torch.Generator().manual_seed(4))
    assert out[2].abs().max() == 0 and out[1, 500:].abs().max() == 0
    assert 0.9 < out[0].std().item() < 1.1
    torch.testing.assert_close(method(x, lens, torch.Generator().manual_seed(4)), out, rtol=0, atol=0)
