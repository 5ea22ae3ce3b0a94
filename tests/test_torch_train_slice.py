"""The port's training step vs the JAX package's, on the CPU.

The JAX side runs ``make_train_step`` with ``TFASR_LOSS_IMPL=xla`` and the
port ``loss_impl="xla"`` (the scan DP loss over the logits, the four fused
encoder kernels in Pallas interpret mode); ``test_torch_train_default.py``
runs the same checks on the default fused joint+loss step. Both sides start from the same weights
and BatchNorm statistics (``bridge.py``) and a fresh Adam, f32, dropout 0.

Tolerances (f32, summation order only): the loss and ``grad_norm`` to 1e-5
relative; each gradient, parameter and running statistic to 1e-4 of its
tensor's largest magnitude (weight gradients are sums over all frames and
lattice cells, so an elementwise bound would fail where they cancel), plus
1e-6 of the model's largest gradient. That floor is for the gradients that
are zero in exact arithmetic — the attention key and encoding biases (a
per-row constant under the softmax) and the conv biases ahead of a
BatchNorm — which are f32 noise (~1e-7) on both sides. Adam would turn
that noise into steps of ~lr (and the conv biases' steps into shifts of
the running means), so both sides freeze exactly those parameters for the
K-step comparison. For the same reason, a single weight whose gradient at
some step lies at that noise floor (below 1e-6 of the largest gradient)
takes an Adam step of a size that depends on the noise, so after K steps
such weights are held to 2·K·lr of JAX's. A gradient that is exactly 0 (an
embedding row of a token the batch lacks, a ReLU unit dead on every frame)
is not noise: Adam leaves its weight where it was on both sides. Measured when this was written:
loss within 1e-7 and ``grad_norm`` within 1.3e-6 relative; every other
gradient within 2e-7 of the largest gradient.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu.ops import losses as jlosses
from tensorflowasr_tpu.ops import rnnt_loss as jrnnt
from tensorflowasr_tpu.optimizers import build_optimizer as jbuild_optimizer
from tensorflowasr_tpu.training import trainer as jtrainer
from tensorflowasr_tpu_torch import bridge, schemas
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tensorflowasr_tpu_torch.ops.losses import masked_mean
from tensorflowasr_tpu_torch.ops.rnnt_loss import rnnt_loss
from tensorflowasr_tpu_torch.optimizers import build_optimizer
from tensorflowasr_tpu_torch.training.trainer import Trainer
from tests.test_torch_slice import TINY_CFG

REL = 1e-4
# parameters whose gradient is zero in exact arithmetic (see the module docstring); the last three, DeepSpeech2's,
# Jasper's and ContextNet's conv biases, each ahead of a BatchNorm
FROZEN = ("key.bias", "encoding.bias", "subsampling.conv_0.bias", "subsampling.conv_1.bias", "dw_conv.bias", "conv2d.bias", "conv1d.bias",
          "pointwise.bias")
ADAM = {"class_name": "Adam", "config": {"learning_rate": 1e-3}}
K_STEPS = 3


def _close_scaled(got, ref, rel=REL, floor=1e-7, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(initial=0.0), np.abs(ref).max(initial=0.0)
    assert err <= rel * scale + floor, f"{what}: max abs err {err} > {rel} x {scale} + {floor}"


def _zero_grad_params(ref_grads: dict) -> set:
    """Parameters whose gradient is zero in exact arithmetic: f32 noise below 1e-5 of the largest gradient."""
    gmax = max(np.abs(g.numpy()).max() for g in ref_grads.values())
    return {name for name, g in ref_grads.items() if np.abs(g.numpy()).max() < 1e-5 * gmax}


def _batch(rng, b=3, n=8000, u=6):
    sig = (rng.standard_normal((b, n)) * 0.5).astype(np.float32)
    lens = np.array([n, 5600, 3000], np.int32)[:b]
    label_len = np.array([u, 4, 2], np.int32)[:b]
    labels = rng.integers(1, TINY_CFG["vocab_size"], (b, u)).astype(np.int32)
    labels[np.arange(u)[None, :] >= label_len[:, None]] = 0
    preds = np.concatenate([np.zeros((b, 1), np.int32), labels], axis=1)
    return sig, lens, preds, label_len + 1, labels, label_len


def _jax_batch(arrs):
    sig, lens, preds, plen, labels, llen = map(jnp.asarray, arrs)
    return jschemas.TrainData(jschemas.TrainInput(sig, lens, preds, plen), jschemas.TrainLabel(labels, llen))


def _torch_batch(arrs):
    sig, lens, preds, plen, labels, llen = (torch.tensor(a) for a in arrs)
    return schemas.TrainData(schemas.TrainInput(sig, lens.long(), preds.long(), plen.long()), schemas.TrainLabel(labels.long(), llen.long()))


def _record_grads():
    """An optax stage that keeps the last gradients in its state and passes them on."""
    return optax.GradientTransformation(lambda params: params, lambda updates, state, params=None: (updates, updates))


def run_both(loss_impl: str, rnn_impl: str = "auto", cfg: dict = TINY_CFG, jax_cls=JConformer, port_cls=Conformer):
    """K Adam steps on both sides from the same start, JAX with
    ``TFASR_LOSS_IMPL=loss_impl`` and ``TFASR_RNN_IMPL=rnn_impl`` (held
    around the whole JAX run: JAX reads them when it applies and traces) and
    the port with ``loss_impl`` and ``rnn_impl`` (a transducer's); per step
    (loss, grad_norm, grads), and the final params and batch_stats. The
    models are ``jax_cls`` and ``port_cls`` built from ``cfg``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFASR_LOSS_IMPL", loss_impl)
        mp.setenv("TFASR_RNN_IMPL", rnn_impl)
        rng = np.random.default_rng(0)
        arrs = _batch(rng)
        jm = jax_cls.from_config(cfg)
        jb = _jax_batch(arrs)
        v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(jax.random.PRNGKey(1), jb.inputs))
        if "batch_stats" in v:  # a model without BatchNorm (the RNN-T) has none
            v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
        port_name = lambda path: ".".join(str(k.key) for k in path if str(k.key) not in bridge._DROP)
        labels = jax.tree_util.tree_map_with_path(lambda path, _: "frozen" if port_name(path).endswith(FROZEN) else "adam", v["params"])
        tx = optax.chain(_record_grads(), optax.multi_transform({"adam": jbuild_optimizer(ADAM), "frozen": optax.set_to_zero()}, labels))
        jvars = dict(v)
        if "batch_stats" not in jvars:
            # JAX's make_train_step applies with mutable=[] when a model has no statistics, and flax then returns a
            # tuple where the step reads the output; an entry that no module reads makes the step run as written
            jvars["batch_stats"] = {"no_batch_norm": {"mean": np.zeros(1, np.float32)}}
        state = jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, jvars), tx, jax.random.PRNGKey(0))
        step = jax.jit(jtrainer.make_train_step(jm, tx))
        jax_steps = []
        for _ in range(K_STEPS):
            state, metrics = step(state, jb)
            jax_steps.append((float(metrics["loss"]), float(metrics["grad_norm"]), jax.tree_util.tree_map(np.asarray, state.opt_state[0])))
        jax_final = jax.tree_util.tree_map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
        if "batch_stats" not in v:
            del jax_final["batch_stats"]

    takes_rnn_impl = "rnn_impl" in inspect.signature(port_cls.from_config).parameters  # a transducer's, DeepSpeech2's
    tm = port_cls.from_config(cfg, device="cpu", **({"rnn_impl": rnn_impl} if takes_rnn_impl else {}))
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    trainer = Trainer(tm, ADAM, device="cpu", loss_impl=loss_impl)
    tstate = trainer.init_state(seed=0)
    tstate.optimizer = build_optimizer(ADAM, [p for n, p in tm.named_parameters() if not n.endswith(FROZEN)])
    tb = _torch_batch(arrs)
    torch_steps = []
    for _ in range(K_STEPS):
        tstate, metrics = trainer.train_step(tstate, tb)
        grads = {name: p.grad.clone() for name, p in tm.named_parameters()}
        torch_steps.append((float(metrics["loss"]), float(metrics["grad_norm"]), grads))
    return jax_steps, jax_final, torch_steps, tm, v


@pytest.fixture(scope="module")
def runs():
    return run_both("xla")


def check_first_step_loss_and_grad_norm(runs):
    jax_steps, _, torch_steps, _, _ = runs
    (jl, jn, _), (tl, tn, _) = jax_steps[0], torch_steps[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=1e-5)


def check_first_step_every_gradient(runs):
    jax_steps, _, torch_steps, tm, _ = runs
    ref = bridge.state_dict_from_flax({"params": jax_steps[0][2]})
    got = torch_steps[0][2]
    assert set(got) == set(ref) - {k for k in ref if k.endswith(("running_mean", "running_var"))}
    gmax = max(np.abs(r.numpy()).max() for r in ref.values())
    for name, g in got.items():
        _close_scaled(g.numpy(), ref[name].numpy(), floor=1e-6 * gmax, what=name)
    assert _zero_grad_params({k: ref[k] for k in got}) == {k for k in got if k.endswith(FROZEN)}


def check_k_adam_steps(runs):
    jax_steps, jax_final, torch_steps, tm, _ = runs
    for k in range(K_STEPS):
        np.testing.assert_allclose(torch_steps[k][0], jax_steps[k][0], rtol=1e-5, err_msg=f"loss at step {k}")
        np.testing.assert_allclose(torch_steps[k][1], jax_steps[k][1], rtol=1e-4, err_msg=f"grad_norm at step {k}")
    ref = bridge.state_dict_from_flax(jax_final)
    grads = [bridge.state_dict_from_flax({"params": step[2]}) for step in jax_steps]
    floors = [1e-6 * max(np.abs(g.numpy()).max() for g in step.values()) for step in grads]
    got = tm.state_dict()
    assert set(got) == set(ref)
    noisy_total = 0
    for name, value in got.items():
        value, want = value.numpy(), ref[name].numpy()
        noisy = np.zeros(want.shape, bool)
        if name in grads[0] and not name.endswith(FROZEN):
            noisy = np.any([(np.abs(g[name].numpy()) < f) & (g[name].numpy() != 0) for g, f in zip(grads, floors)], axis=0)
        noisy_total += int(noisy.sum())
        _close_scaled(np.where(noisy, want, value), want, what=name)
        assert np.abs(value - want)[noisy].max(initial=0.0) <= 2 * K_STEPS * ADAM["config"]["learning_rate"], name
    assert noisy_total < 0.01 * sum(v.numel() for v in got.values())
    assert jax_steps[-1][0] < jax_steps[0][0] and torch_steps[-1][0] < torch_steps[0][0]


def test_first_step_loss_and_grad_norm_match_jax(runs):
    check_first_step_loss_and_grad_norm(runs)


def test_first_step_every_gradient_matches_jax(runs):
    check_first_step_every_gradient(runs)


def test_k_adam_steps_match_jax(runs):
    check_k_adam_steps(runs)


def test_batch_stats_round_trip_through_bridge(runs):
    _, jax_final, _, tm, v = runs
    back = bridge.batch_stats_to_flax(tm.state_dict(), v["batch_stats"])
    flat = lambda t: {tuple(str(k.key) for k in path): leaf for path, leaf in jax.tree_util.tree_leaves_with_path(t)}
    ref, got = flat(jax_final["batch_stats"]), flat(back)
    assert set(ref) == set(got)
    for path, value in got.items():
        _close_scaled(value, ref[path], what="/".join(path))
        assert not np.allclose(value, flat(v["batch_stats"])[path])  # the K steps moved the running statistics


def test_dropout_training_loss_falls():
    cfg = {**TINY_CFG, "encoder_dropout": 0.1}
    model = Conformer.from_config(cfg, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(3))
    trainer = Trainer(model, ADAM, device="cpu")
    state = trainer.init_state(seed=5)
    batch = _torch_batch(_batch(np.random.default_rng(4)))
    losses = [float(trainer.train_step(state, batch)[1]["loss"]) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 6


def test_fit_steps_and_evaluates():
    model = Conformer.from_config(TINY_CFG, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(6))
    trainer = Trainer(model, ADAM, device="cpu")
    batch = _torch_batch(_batch(np.random.default_rng(7)))
    before = trainer.eval_step(trainer.init_state(), batch)["loss"].item()
    state = trainer.fit(trainer.init_state(seed=1), [batch] * 3, epochs=2, steps_per_epoch=2, eval_data=[batch])
    assert state.step == 4
    after = trainer.eval_step(state, batch)["loss"].item()
    assert np.isfinite(after) and after < before


def test_entry_points_run_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Conformer.from_config(TINY_CFG)
    model = Conformer.from_config(TINY_CFG, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, ADAM)
    assert next(model.parameters()).device.type == "cpu"


def test_unported_optimizer_options_raise():
    """What still raises is an optimizer the JAX package does not know
    (a ``KeyError``, as JAX's ``build_base_optimizer``); accumulation,
    gradient noise, clipping and schedules build (``test_torch_optimizers.py``)."""
    params = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(KeyError, match="Unknown optimizer 'lamb'"):
        build_optimizer({"class_name": "tensorflow_addons.optimizers>Lamb", "config": {}}, params)
    opt = build_optimizer({"class_name": "AdamW", "config": {"learning_rate": 1e-4, "weight_decay": 0.01}}, params, ga_steps=2, clip_norm=1.0)
    assert isinstance(opt.base, torch.optim.AdamW) and opt.base.defaults["eps"] == 1e-7 and opt.ga_steps == 2


# ------------------------------------------- loss ------------------------------------------- #


def _loss_inputs(rng):
    """Ragged T and U; row 2's labels outnumber its frames (the clamp); row 3 has no frames."""
    b, t, u, v = 4, 7, 5, 6
    logits = rng.standard_normal((b, t, u + 1, v)).astype(np.float32)
    logit_length = np.array([7, 5, 2, 0], np.int32)
    label_length = np.array([5, 3, 4, 2], np.int32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    return logits, logit_length, labels, label_length


def test_rnnt_loss_values_and_grads_match_jax():
    logits, tl, labels, ll = _loss_inputs(np.random.default_rng(9))
    ok = slice(0, 2)  # rows whose lengths the unmasked DP takes as they are
    ref, vjp = jax.vjp(lambda x: jrnnt.rnnt_loss(x, jnp.asarray(tl[ok]), jnp.asarray(labels[ok]), jnp.asarray(ll[ok])), jnp.asarray(logits[ok]))
    x = torch.tensor(logits[ok], requires_grad=True)
    got = rnnt_loss(x, torch.tensor(tl[ok]), torch.tensor(labels[ok]), torch.tensor(ll[ok]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5)
    w = np.array([0.7, -1.3], np.float32)
    got.backward(torch.tensor(w))
    _close_scaled(x.grad.numpy(), np.asarray(vjp(jnp.asarray(w))[0]), rel=1e-5, what="dlogits")


def test_masked_mean_loss_matches_jax():
    """Clamped label length, a zero-frame row left out of the mean, values and gradients."""
    logits, tl, labels, ll = _loss_inputs(np.random.default_rng(10))
    jfn = jlosses.masked_mean(jrnnt.rnnt_loss)
    ref, grad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll)))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = masked_mean(rnnt_loss)(x, torch.tensor(tl), torch.tensor(labels), torch.tensor(ll))
    got.backward()
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    _close_scaled(x.grad.numpy(), np.asarray(grad), rel=1e-5, what="dlogits")
    assert float(x.grad[3].abs().max()) == 0.0
