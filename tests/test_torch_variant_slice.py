"""Tiny models built with the layers the port took last, against the JAX
package, on the CPU, f32, dropout 0.

- ``l1``: a 2-block Conformer-Transducer with MFCC features, VGG
  subsampling, vanilla MHA (kernel A's plain version), a one-hot label
  encoder and a GRU prediction net;
- ``l2``: the same with log-gammatone features, Conv1d subsampling,
  post-norm modules under a pre-norm block, a grouped depthwise conv with
  LayerNorm, all three residual factors trainable, no attention auto mask
  and a simple-RNN prediction net (the FF and conv modules on their plain
  route, as in JAX);
- ``ds2_gru``: a 2-layer bidirectional DeepSpeech2 with GRU layers, and its
  unidirectional layout streamed 3 chunks with the GRU carries passed on.

Each is held to JAX from the same weights (``bridge.py``, BatchNorm running
statistics moved off 0/1): the encoder output, ``recognize``'s tokens and
next decoder states (the transducers decode through the eager WIND loop:
the fused decode declines a GRU, a simple RNN and a one-hot net, as JAX's
does), one ``xla`` training step's loss, ``grad_norm`` and every gradient,
3 Adam steps and an eval step, with the checks and tolerances of
``tests/test_torch_train_slice.py`` (the loss to 1e-5 relative, each
gradient and parameter to 1e-4 of its scale plus 1e-6 of the largest
gradient), with two exceptions that ``l2`` needs. Its f32 step is the
least well conditioned of the slices (log-gammatone features of magnitude
~10 into a Conv1d, post-norm modules): against a float64 run of the port
on the same weights and batch, both packages' gradients lie up to ~1e-4
of their scale away (JAX 9.3e-5, the port 1.8e-4 on the worst), and
``grad_norm`` 1.2e-6 (JAX) and 1.3e-5 (the port) away, most of it the
first conv's weight gradient, a sum over every frame. So ``grad_norm`` is
held to 1e-4 relative on the first step, as ``check_k_adam_steps`` holds
it on every step; and the trainable residual factors' gradients, each a
scalar sum of branch·dout over B·T·D products whose terms cancel (their
absolute sum ~40× the result in ``l2``), to 5e-4 of their scale; after
the K Adam steps, ``l2``'s parameters are held to 1e-4 of their scale
plus K·lr·2e-4 (``L2_PARAM_FLOOR``). A
gradient that is zero in exact arithmetic is f32 noise there;
``check_zero_gradients`` asks that every such gradient be one of the
parameters that ``run_both`` freezes on both sides; ``l2``'s grouped
depthwise conv bias feeds a LayerNorm over channels, so it has a gradient
and trains there. JAX runs its XLA routes for the FF, conv
and attention modules (``TFASR_{FF,CONV,ATTN}_IMPL=xla``), the same
functions its Pallas kernels compute in interpret mode (held elsewhere).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.models.ctc import base as jctc
from tensorflowasr_tpu.models.ctc.deepspeech2 import DeepSpeech2 as JDeepSpeech2
from tensorflowasr_tpu.models.transducer import base as jbase
from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu.training import trainer as jtrainer
from tensorflowasr_tpu_torch import bridge, schemas
from tensorflowasr_tpu_torch.models.ctc.base import recognize as ctc_recognize
from tensorflowasr_tpu_torch.models.ctc.deepspeech2 import DeepSpeech2
from tensorflowasr_tpu_torch.models.transducer.base import recognize
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tensorflowasr_tpu_torch.ops import frontend
from tensorflowasr_tpu_torch.training.trainer import Trainer
from tests.test_torch_ctc_family import DS2_BASE, DS2_UNI
from tests.test_torch_slice import TINY_CFG
from tests import test_torch_train_slice as train_slice
from tests.test_torch_train_slice import ADAM, FROZEN, _batch, _close_scaled, _jax_batch, _torch_batch, _zero_grad_params, check_k_adam_steps, run_both

L1_CFG = {
    **TINY_CFG,
    "speech_config": {**TINY_CFG["speech_config"], "feature_type": "mfcc"},
    "encoder_subsampling": {"class_name": "tensorflow_asr.models.layers.subsampling>VggSubsampling",
                            "config": {"filters": [4, 8], "kernel_size": 3, "pool_size": 2, "strides": 2}},
    "encoder_mha_type": "mha",
    "prediction_label_encode_mode": "one_hot",
    "prediction_rnn_type": "gru",
}
L2_CFG = {
    **TINY_CFG,
    "speech_config": {**TINY_CFG["speech_config"], "feature_type": "log_gammatone_spectrogram"},
    "encoder_subsampling": {"class_name": "tensorflow_asr.models.layers.subsampling>Conv1dSubsampling",
                            "config": {"filters": [16, 16], "strides": [2, 2], "kernels": [3, 3], "paddings": ["causal", "causal"],
                                       "norms": ["batch", "batch"], "activations": ["swish", "swish"]}},
    "encoder_module_norm_position": "post",
    "encoder_block_norm_position": "pre",
    "encoder_convm_use_group_conv": True,
    "encoder_convm_dw_norm_type": "layer",
    "encoder_ffm_residual_factor": "trainable",
    "encoder_mhsam_residual_factor": "trainable",
    "encoder_convm_residual_factor": "trainable",
    "encoder_use_attention_auto_mask": False,
    "prediction_rnn_type": "rnn",
}
DS2_GRU = {**DS2_BASE, "rnn_type": "gru"}
DS2_GRU_UNI = {**DS2_UNI, "rnn_type": "gru"}
# name: (JAX class, port class, config)
MODELS = {"l1": (JConformer, Conformer, L1_CFG), "l2": (JConformer, Conformer, L2_CFG), "ds2_gru": (JDeepSpeech2, DeepSpeech2, DS2_GRU)}


@pytest.fixture(autouse=True)
def _jax_xla_modules(monkeypatch):
    for name in ("TFASR_FF_IMPL", "TFASR_CONV_IMPL", "TFASR_ATTN_IMPL"):
        monkeypatch.setenv(name, "xla")


def _pair(name: str, cfg: dict | None = None):
    """JAX model and variables (BatchNorm statistics moved off 0/1) and the port's model with them."""
    jcls, tcls, model_cfg = MODELS[name]
    cfg = cfg or model_cfg
    rng = np.random.default_rng(11)
    arrs = _batch(rng)
    jm = jcls.from_config(cfg)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(jax.random.PRNGKey(1), _jax_batch(arrs).inputs))
    v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    tm = tcls.from_config(cfg, device="cpu")
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    return jm, v, tm.eval(), arrs


@pytest.mark.parametrize("name", sorted(MODELS))
def test_encoder_and_recognize_match_jax(name):
    jm, v, tm, arrs = _pair(name)
    sig, lens = arrs[0], arrs[1]
    ref, ref_len, _ = jax.jit(lambda v_, s_, l_: jm.apply(v_, s_, l_, method=jm.encode))(v, jnp.asarray(sig), jnp.asarray(lens))
    with torch.inference_mode():
        got, got_len, _ = tm.encode(torch.tensor(sig), torch.tensor(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5 * max(1.0, np.abs(np.asarray(ref)).max()))
    pin = jschemas.PredictInput(jnp.asarray(sig), jnp.asarray(lens), None, None, None)
    if name == "ds2_gru":
        ref_out = jax.jit(lambda v_, p_: jctc.recognize(jm, v_, p_))(v, pin)
        out = ctc_recognize(tm, schemas.PredictInput(torch.tensor(sig), torch.tensor(lens)))
        np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref_out.tokens))
        return
    assert tm.decode_params() is None  # the fused decode declines a GRU, a simple RNN and a one-hot net, as JAX's
    ref_out = jbase.recognize(jm, v, pin)
    out = recognize(tm, schemas.PredictInput(torch.tensor(sig), torch.tensor(lens)))
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref_out.tokens))
    np.testing.assert_array_equal(out.next_tokens.numpy(), np.asarray(ref_out.next_tokens))
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, ref_out.next_decoder_states)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, out.next_decoder_states, is_leaf=torch.is_tensor))
    for g, r in zip(jax.tree_util.tree_leaves(out.next_decoder_states, is_leaf=torch.is_tensor), jax.tree_util.tree_leaves(ref_out.next_decoder_states)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-5)


@pytest.fixture(scope="module", params=sorted(MODELS))
def runs(request):
    jcls, tcls, cfg = MODELS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        for name in ("TFASR_FF_IMPL", "TFASR_CONV_IMPL", "TFASR_ATTN_IMPL"):
            mp.setenv(name, "xla")
        if cfg.get("encoder_convm_dw_norm_type", "batch") != "batch":
            # the depthwise conv bias has a gradient when no BatchNorm follows it: train it (a frozen weight's
            # gradient would pile up in .grad on the port's side, outside the optimizer that zeroes the others)
            mp.setattr(train_slice, "FROZEN", tuple(f for f in FROZEN if f != "dw_conv.bias"))
        return run_both("xla", cfg=cfg, jax_cls=jcls, port_cls=tcls)


def test_train_step_loss_and_grad_norm_match_jax(runs):
    jax_steps, _, torch_steps, _, _ = runs
    (jl, jn, _), (tl, tn, _) = jax_steps[0], torch_steps[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)


def check_zero_gradients(runs):
    """Every gradient within tolerance of JAX's; those zero in exact arithmetic are among the frozen parameters."""
    jax_steps, _, torch_steps, _, _ = runs
    ref = bridge.state_dict_from_flax({"params": jax_steps[0][2]})
    got = torch_steps[0][2]
    assert set(got) == set(ref) - {k for k in ref if k.endswith(("running_mean", "running_var"))}
    gmax = max(np.abs(r.numpy()).max() for r in ref.values())
    for name, g in got.items():
        _close_scaled(g.numpy(), ref[name].numpy(), rel=5e-4 if name.endswith("residual.factor") else 1e-4, floor=1e-6 * gmax, what=name)
    assert _zero_grad_params({k: ref[k] for k in got}) <= {k for k in got if k.endswith(FROZEN)}


def test_train_step_every_gradient_matches_jax(runs):
    check_zero_gradients(runs)


# l2's parameters after K Adam steps: an update taken from a gradient known to ~2e-4 relative (the float64 referee
# above) is known to ~2e-4 of lr, so a parameter that starts at 0 (a bias) is held within K·lr·2e-4 besides 1e-4 of its scale
L2_PARAM_FLOOR = train_slice.K_STEPS * ADAM["config"]["learning_rate"] * 2e-4


def test_train_k_adam_steps_match_jax(runs, request, monkeypatch):
    if request.node.callspec.id == "l2":
        monkeypatch.setattr(train_slice, "_close_scaled", functools.partial(_close_scaled, floor=L2_PARAM_FLOOR))
    check_k_adam_steps(runs)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_step_matches_jax(name, monkeypatch):
    monkeypatch.setenv("TFASR_LOSS_IMPL", "xla")
    jm, v, tm, arrs = _pair(name)
    import optax

    state = jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, v), optax.adam(1e-3), jax.random.PRNGKey(0))
    ref = float(jtrainer.make_eval_step(jm)(state, _jax_batch(arrs))["loss"])
    trainer = Trainer(tm, ADAM, device="cpu", loss_impl="xla")
    got = float(trainer.eval_step(trainer.init_state(), _torch_batch(arrs))["loss"])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_gru_deepspeech2_uni_streams_through_recognize_as_jax():
    """3 chunks of 16 frames through both ``recognize``s, each GRU layer's
    bare ``h`` carried: every chunk's logits, tokens and next states equal JAX's."""
    jm, v, tm, _ = _pair("ds2_gru", DS2_GRU_UNI)
    cfg = frontend.FrontendConfig(**DS2_GRU_UNI["speech_config"])
    size, step = cfg.get_signal_chunk_size_and_step(16)
    sig = (np.random.default_rng(7).standard_normal((1, 2 * step + size)) * 0.5).astype(np.float32)
    jstate, tstate = jm.init_encoder_states(1), tm.init_encoder_states(1)
    assert len(tstate) == 2 and all(torch.is_tensor(s) and s.shape == (1, 16) for s in tstate)
    jencode = jax.jit(lambda v_, s_, l_, st_: jm.apply(v_, s_, l_, st_, method=jm.encode))
    jrec = jax.jit(lambda v_, p_: jctc.recognize(jm, v_, p_))
    for i in range(3):
        chunk = sig[:, i * step: i * step + size]
        n = np.array([size], np.int32)
        ref, _, ref_state = jencode(v, jnp.asarray(chunk), jnp.asarray(n), jstate)
        ref_tokens = jrec(v, jschemas.PredictInput(jnp.asarray(chunk), jnp.asarray(n), None, jstate, None)).tokens
        with torch.inference_mode():
            got, _, got_state = tm.encode(torch.tensor(chunk), torch.tensor(n), initial_state=tstate)
        out = ctc_recognize(tm, schemas.PredictInput(torch.tensor(chunk), torch.tensor(n), None, tstate, None))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5 * max(1.0, np.abs(np.asarray(ref)).max()))
        np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref_tokens))
        for g, r in zip(got_state, ref_state):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)
        for g, r in zip(out.next_encoder_states, got_state):
            np.testing.assert_array_equal(g.numpy(), r.numpy())
        jstate, tstate = ref_state, got_state
