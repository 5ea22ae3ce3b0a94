"""The port's optimizer chain (``tensorflowasr_tpu_torch/optimizers/``) vs the
JAX package's optax chain, on the CPU.

Schedules at counts 0–50,000 (the clamp to ≥ 1, the bounds, a string
``max_lr``) to 1e-6 relative; each base optimizer over 5 updates under a
varying schedule to 1e-6 relative; clipping below and above ``max_norm``;
gradient noise with JAX's draws (replayed from ``PRNGKey(42)``) injected,
across ``start_step``; accumulation against ``optax.MultiSteps`` at k = 4
over 8 micro-steps. All f32: the two sides differ in the order of a few
roundings, and in one place more: optax forms Adam's bias corrections
1 − βᵗ in f32 from β rounded to f32 (1 − 0.999 becomes 0.00099998713),
``torch.optim.Adam`` in float64, so Adam's first step differs by 6.4e-6
of itself (decaying with t). At the learning rates of the published
recipes (≤ 1.5e-3) that stays below 1e-6 of the parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowasr_tpu.optimizers import build_optimizer as jbuild_optimizer
from tensorflowasr_tpu.optimizers import schedules as jschedules
from tensorflowasr_tpu.optimizers.optimizers import gradient_noise as jgradient_noise
from tensorflowasr_tpu_torch.optimizers import build_optimizer, build_schedule
from tensorflowasr_tpu_torch.optimizers.optimizers import GradientNoise, clip_by_global_norm, global_norm
from tensorflowasr_tpu_torch.optimizers.schedules import _eval_lr

NOAM = "tensorflow_asr.optimizers.schedules>TransformerSchedule"
SCHEDULES = [
    {"class_name": NOAM, "config": {"dmodel": 144, "warmup_steps": 10000, "max_lr": "0.05/(144**0.5)", "scale": 2.0}},
    {"class_name": NOAM, "config": {"dmodel": 512, "warmup_steps": 10000, "scale": 1.0}},
    {"class_name": "TransformerSchedule", "config": {"dmodel": 176, "warmup_steps": 4000, "max_lr": 1e-3, "min_lr": "1e-5"}},
    {"class_name": "CyclicTransformerSchedule", "config": {"dmodel": 144, "step_size": 2000, "max_lr": "0.05/(144**0.5)", "warmup_steps": 4000}},
]
COUNTS = np.unique(np.concatenate([np.arange(0, 40), np.linspace(0, 50000, 401).astype(np.int64), [3999, 4000, 4001, 9999, 10000, 10001]]))
# a schedule that moves over 5 updates (2.4e-4 → 1.4e-3 → 1.25e-3): warm-up 3, then the √ decay
SHORT = {"class_name": "TransformerSchedule", "config": {"dmodel": 16, "warmup_steps": 3, "scale": 0.01}}
BASES = [
    {"class_name": "Adam", "config": {"learning_rate": SHORT, "beta_2": 0.98, "epsilon": 1e-9}},
    {"class_name": "Adam", "config": {"learning_rate": SHORT, "weight_decay": 1e-2}},
    {"class_name": "SGD", "config": {"learning_rate": SHORT, "nesterov": True}},
    {"class_name": "SGD", "config": {"learning_rate": SHORT, "momentum": 0.9, "nesterov": True}},
    {"class_name": "RMSprop", "config": {"learning_rate": SHORT}},
    {"class_name": "RMSprop", "config": {"learning_rate": "1e-2", "momentum": 0.9, "rho": 0.8}},
    {"class_name": "Adadelta", "config": {"learning_rate": SHORT}},
]


def _grads(rng, n: int):
    """``n`` gradient trees {"b": [4], "w": [3, 4]} (the order optax flattens them in)."""
    return [{"b": rng.standard_normal(4).astype(np.float32), "w": rng.standard_normal((3, 4)).astype(np.float32)} for _ in range(n)]


def _params(rng):
    return {"b": rng.standard_normal(4).astype(np.float32), "w": rng.standard_normal((3, 4)).astype(np.float32)}


def _port(params: dict) -> list[torch.nn.Parameter]:
    return [torch.nn.Parameter(torch.tensor(params[k])) for k in ("b", "w")]


def _set_grads(params, grads: dict) -> None:
    for p, k in zip(params, ("b", "w")):
        p.grad = torch.tensor(grads[k])


@pytest.mark.parametrize("config", SCHEDULES, ids=lambda c: c["class_name"].split(">")[-1] + "-" + str(c["config"]["dmodel"]))
def test_schedules_match_jax(config):
    ref = np.asarray(jschedules.build_schedule(config)(jnp.asarray(COUNTS)))
    port = build_schedule(config)
    got = np.array([port(int(c)) for c in COUNTS])
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got[0] == got[1]  # the count is clamped to ≥ 1
    if "max_lr" in config["config"]:
        assert got.max() <= _eval_lr(config["config"]["max_lr"]) * (1 + 1e-6)


def test_numeric_learning_rates():
    assert build_schedule("0.05/(144**0.5)") == pytest.approx(0.05 / 12.0, rel=1e-12)
    assert build_schedule(3e-4) == 3e-4
    with pytest.raises(NameError):
        build_schedule("__import__('os')")


@pytest.mark.parametrize("config", BASES, ids=lambda c: c["class_name"] + "-" + "-".join(k for k in c["config"] if k != "learning_rate"))
def test_base_optimizers_match_optax(config):
    rng = np.random.default_rng(0)
    p0, grads = _params(rng), _grads(rng, 5)
    tx = jbuild_optimizer(config)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)
    params = _port(p0)
    chain = build_optimizer(config, params)
    for k, g in enumerate(grads):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        _set_grads(params, g)
        assert chain.step()
        for p, key in zip(params, ("b", "w")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[key]), rtol=1e-6, atol=1e-7, err_msg=f"{key} after update {k}")
    assert chain.count == 5


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    g = jax.tree_util.tree_map(lambda a: a * np.float32(scale), _grads(np.random.default_rng(1), 1)[0])
    ref, _ = optax.clip_by_global_norm(1.0).update(jax.tree_util.tree_map(jnp.asarray, g), None)
    got = [torch.tensor(g[k]) for k in ("b", "w")]
    norm = global_norm(got)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
    clip_by_global_norm(got, norm, 1.0)
    for t, k in zip(got, ("b", "w")):
        if scale < 1:
            np.testing.assert_array_equal(t.numpy(), g[k])  # below max_norm: untouched
        np.testing.assert_allclose(t.numpy(), np.asarray(ref[k]), rtol=1e-6)
    assert (global_norm(got).item() <= 1.0 + 1e-6) and (scale < 1 or global_norm(got).item() == pytest.approx(1.0, rel=1e-6))


def _jax_noise_draws(n_updates: int) -> list[list[np.ndarray]]:
    """JAX ``gradient_noise``'s unit normals per update, leaves in flatten order (b, w)."""
    key, out = jax.random.PRNGKey(42), []
    for _ in range(n_updates):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, 2)
        out.append([np.asarray(jax.random.normal(k, s, jnp.float32)) for k, s in zip(keys, ((4,), (3, 4)))])
    return out


@pytest.mark.parametrize("start_step", [0, 2])
def test_gradient_noise_matches_jax(start_step):
    grads = _grads(np.random.default_rng(2), 5)
    tx = jgradient_noise(gamma=0.55, eta=0.3, start_step=start_step)
    state = tx.init(None)
    noise = GradientNoise(gamma=0.55, eta=0.3, start_step=start_step)
    draws = _jax_noise_draws(5)
    noise.draw = lambda gs: [torch.tensor(d) for d in draws[noise.count]]  # JAX draws at every update, active or not
    for k, g in enumerate(grads):
        ref, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state)
        got = [torch.tensor(g[key]) for key in ("b", "w")]
        noise(got)
        for t, key in zip(got, ("b", "w")):
            np.testing.assert_allclose(t.numpy(), np.asarray(ref[key]), rtol=1e-6, atol=1e-7, err_msg=f"{key} at update {k}")
            if k < start_step:
                np.testing.assert_array_equal(t.numpy(), g[key])
        assert noise.count == int(state["count"])


def test_gradient_noise_stream_is_its_own():
    """Seeded 42 whatever the training seed: two chains draw the same noise."""
    draws = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        noise = GradientNoise(eta=1.0)
        g = [torch.zeros(3, 4)]
        noise(g)
        draws.append(g[0])
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    assert 0.5 < draws[0].std().item() < 1.5


def test_accumulation_matches_multisteps():
    """k = 4 over 8 micro-steps, with the whole chain on: updates only on the
    emit steps, parameters and counts unchanged between them."""
    config = {"class_name": "Adam", "config": {"learning_rate": SHORT, "weight_decay": 1e-3}}
    rng = np.random.default_rng(3)
    p0, grads = _params(rng), _grads(rng, 8)
    tx = jbuild_optimizer(config, ga_steps=4, clip_norm=2.0)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)
    params = _port(p0)
    chain = build_optimizer(config, params, ga_steps=4, clip_norm=2.0)
    for k, g in enumerate(grads):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        before = [p.detach().clone() for p in params]
        _set_grads(params, g)
        emitted = chain.step(grad_norm=global_norm([p.grad for p in params]))
        assert emitted == ((k + 1) % 4 == 0)
        assert (chain.mini_step, chain.count) == (int(state.mini_step), int(state.gradient_step))
        for p, b, key in zip(params, before, ("b", "w")):
            if not emitted:
                assert torch.equal(p.detach(), b)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[key]), rtol=1e-6, atol=1e-7, err_msg=f"{key} after micro-step {k}")
    assert chain.count == 2


def test_every_option_builds():
    params = [torch.nn.Parameter(torch.zeros(2))]
    for name in ("Adam", "AdamW", "SGD", "RMSprop", "Adadelta"):
        for lr in (SCHEDULES[0], SCHEDULES[3], "0.05/(144**0.5)", 1e-3):
            build_optimizer({"class_name": name, "config": {"learning_rate": lr}}, params, ga_steps=8, gradn_config={"eta": 1.0}, clip_norm=1.0)
