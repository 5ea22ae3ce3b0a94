"""The Transformer Transducer vs the JAX package, on the CPU, at f32 with
dropout 0, and the checks the other two ported transducers
(``test_torch_transducer_rnnt.py``, ``test_torch_transducer_contextnet.py``)
share with it.

- Tiny model (Conv2d 16/16 subsampling, D 16, 1 relmha block of 4 × 4,
  dff 32; LSTM-16 prediction net, joint 16, V 20): the encoder output, the
  training forward's [B, T, U+1, V] logits and the BatchNorm statistics it
  updates, to 1e-4 of their largest magnitude; greedy tokens through
  ``recognize`` (the fused decode's plain version) and through the eager
  WIND loop equal to JAX ``recognize``'s (beam search:
  ``test_torch_beam_lm.py``).
- The ``auto`` (fused joint + loss) and ``xla`` training steps, each with
  every gradient and 3 Adam steps, and the BatchNorm statistics carried back
  to flax (``bridge.batch_stats_to_flax``), with the checks and tolerances
  of ``test_torch_train_slice.py`` (the ``test_torch_ctc_family.py``
  tolerances); the default eval step's loss (the unfused loss kernels'
  plain versions against JAX's in interpret mode) to 1e-5.
- The published config (``examples/models/transducer/transformer/base.yml.j2``)
  built through ``Config`` and ``build_model`` at full width: every parameter
  name and shape equal to ``bridge.state_dict_from_flax`` of JAX's
  ``jax.eval_shape`` of ``init``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.models import build_model as jbuild_model
from tensorflowasr_tpu.models.transducer import base as jbase
from tensorflowasr_tpu.models.transducer.transformer import TransformerTransducer as JTransformerTransducer
from tensorflowasr_tpu.training import trainer as jtrainer
from tensorflowasr_tpu_torch import bridge, schemas
from tensorflowasr_tpu_torch.configs import Config
from tensorflowasr_tpu_torch.models import build_model
from tensorflowasr_tpu_torch.models.transducer import base as tbase
from tensorflowasr_tpu_torch.models.transducer.transformer import TransformerTransducer
from tensorflowasr_tpu_torch.ops import transducer_decode
from tensorflowasr_tpu_torch.training.trainer import Trainer
from tests.test_torch_train_slice import (ADAM, _batch, _close_scaled, _jax_batch, _torch_batch, check_first_step_every_gradient,
                                          check_first_step_loss_and_grad_norm, check_k_adam_steps, run_both)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEECH = {"sample_rate": 16000, "frame_ms": 25, "stride_ms": 10, "nfft": 512, "num_feature_bins": 40}
_HEAD = {"prediction_label_encode_mode": "embedding", "prediction_embed_dim": 8, "prediction_num_rnns": 1, "prediction_rnn_units": 16,
         "prediction_rnn_type": "lstm", "prediction_layer_norm": True, "joint_dim": 16, "prejoint_encoder_linear": True,
         "prejoint_prediction_linear": True, "joint_activation": "tanh", "joint_mode": "add", "blank": 0, "vocab_size": 20}
TINY = {
    "speech_config": _SPEECH,
    "encoder_subsampling": {"class_name": "tensorflow_asr.models.layers.subsampling>Conv2dSubsampling",
                            "config": {"filters": [16, 16], "kernels": [3, 3], "strides": [2, 2], "paddings": ["causal", "causal"],
                                       "norms": ["batch", "batch"], "activations": ["swish", "swish"]}},
    "encoder_dmodel": 16, "encoder_dff": 32, "encoder_num_blocks": 1, "encoder_head_size": 4, "encoder_num_heads": 4,
    "encoder_mha_type": "relmha", "encoder_dropout": 0.0, **_HEAD,
}


def family_pair(jcls, tcls, cfg, seed: int = 11, rnn_impl: str = "auto"):
    """JAX model and variables (BatchNorm statistics moved off 0/1) and the
    port's model with them, and a batch (``_batch``), for ``cfg``."""
    rng = np.random.default_rng(seed)
    arrs = _batch(rng)
    jm = jcls.from_config(cfg)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(jax.random.PRNGKey(1), _jax_batch(arrs).inputs))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    tm = tcls.from_config(cfg, device="cpu", rnn_impl=rnn_impl)
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    return jm, v, tm, arrs


def check_forward_and_decodes(jm, v, tm, arrs):
    """Encoder output, training-forward logits, the BatchNorm statistics the
    train forward updates, and greedy tokens (fused plain, eager WIND), against JAX."""
    sig, lens = arrs[0], arrs[1]
    ref, ref_len, _ = jax.jit(lambda v_, s_, l_: jm.apply(v_, s_, l_, method=jm.encode))(v, jnp.asarray(sig), jnp.asarray(lens))
    tm.eval()
    with torch.inference_mode():
        got, got_len, _ = tm.encode(torch.tensor(sig), torch.tensor(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    _close_scaled(got.numpy(), np.asarray(ref), what="encoded", floor=0.0)
    jb, tb = _jax_batch(arrs), _torch_batch(arrs)
    jout = jax.jit(lambda v_, x_: jm.apply(v_, x_, train=False))(v, jb.inputs)
    with torch.inference_mode():
        tout = tm(tb.inputs)
    _close_scaled(tout.logits.numpy(), np.asarray(jout.logits), what="logits", floor=0.0)
    if "batch_stats" in v:
        jtrain, updates = jax.jit(lambda v_, x_: jm.apply(v_, x_, train=True, mutable=["batch_stats"]))(v, jb.inputs)
        tm.train()
        ttrain = tm(tb.inputs, train=True)
        tm.eval()
        _close_scaled(ttrain.logits.detach().numpy(), np.asarray(jtrain.logits), what="train logits", floor=0.0)
        stats = bridge.state_dict_from_flax({"params": {}, "batch_stats": jax.tree_util.tree_map(np.asarray, updates["batch_stats"])})
        sd = tm.state_dict()
        for key, value in stats.items():
            np.testing.assert_allclose(sd[key].numpy(), value.numpy(), rtol=1e-5, atol=1e-6, err_msg=key)
        tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    pin = jschemas.PredictInput(jnp.asarray(sig), jnp.asarray(lens), None, None, None)
    ref_greedy = np.asarray(jax.jit(lambda v_, p_: jbase.recognize(jm, v_, p_))(v, pin).tokens)
    tin = schemas.PredictInput(torch.tensor(sig), torch.tensor(lens))
    assert tm.decode_params() is not None
    np.testing.assert_array_equal(tbase.recognize(tm, tin).tokens.numpy(), ref_greedy)
    with torch.inference_mode():
        enc, enc_len, _ = tm.encode(tin.inputs, tin.inputs_length)
        b = enc.shape[0]
        eager = transducer_decode.transducer_greedy_decode_wind(enc, enc_len, tm.pred_step, tm.joint_window, torch.zeros(b, dtype=torch.int64),
                                                                tm.init_decoder_states(b))[0]
    np.testing.assert_array_equal(eager.numpy(), ref_greedy)


def eval_both(jcls, tcls, cfg, loss_impl: str, monkeypatch, rnn_impl: str = "auto"):
    """One eval batch through JAX ``make_eval_step`` (``TFASR_LOSS_IMPL``
    unset for ``auto``) and the port's ``Trainer.eval_step``: (port, JAX) loss."""
    if loss_impl == "auto":
        monkeypatch.delenv("TFASR_LOSS_IMPL", raising=False)
    else:
        monkeypatch.setenv("TFASR_LOSS_IMPL", loss_impl)
    monkeypatch.setenv("TFASR_RNN_IMPL", rnn_impl)
    jm, v, tm, arrs = family_pair(jcls, tcls, cfg, seed=21, rnn_impl=rnn_impl)
    state = jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, v), optax.adam(1e-3), jax.random.PRNGKey(0))
    ref = float(jax.jit(jtrainer.make_eval_step(jm))(state, _jax_batch(arrs))["loss"])
    trainer = Trainer(tm, ADAM, device="cpu", loss_impl=loss_impl)
    return float(trainer.eval_step(trainer.init_state(), _torch_batch(arrs))["loss"]), ref


def check_batch_stats_round_trip(runs):
    _, jax_final, _, tm, v = runs
    back = bridge.batch_stats_to_flax(tm.state_dict(), v["batch_stats"])
    flat = lambda t: {tuple(str(k.key) for k in path): leaf for path, leaf in jax.tree_util.tree_leaves_with_path(t)}
    ref, got = flat(jax_final["batch_stats"]), flat(back)
    assert set(ref) == set(got) and got
    for path, value in got.items():
        _close_scaled(value, ref[path], what="/".join(path))


def check_published_widths(example: str, cls, tmp_path):
    """The example built at full width on the CPU: its class, and each
    parameter's name and shape equal to JAX's (``jax.eval_shape`` of ``init``,
    through the bridge), so the counts are equal too."""
    cfg = Config(os.path.join(REPO, example), modeldir=str(tmp_path))
    vocab = cfg.decoder_config.vocab_size
    model = build_model(cfg.model_config, vocab_size=vocab, device="cpu")
    assert type(model) is cls and model.vocab_size == vocab
    jm = jbuild_model(cfg.model_config, vocab_size=vocab)
    ti = jschemas.TrainInput(jax.ShapeDtypeStruct((1, 1600), jnp.float32), jax.ShapeDtypeStruct((1,), jnp.int32),
                             jax.ShapeDtypeStruct((1, 3), jnp.int32), jax.ShapeDtypeStruct((1,), jnp.int32))
    shapes = jax.eval_shape(lambda x: jm.init({"params": jax.random.PRNGKey(0)}, x, train=False), ti)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    ref = {k: tuple(t.shape) for k, t in bridge.state_dict_from_flax(zeros).items()}
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == ref
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    return model


# ------------------------------ Transformer-T ------------------------------ #


def test_transformer_transducer_forward_and_decodes_match_jax():
    check_forward_and_decodes(*family_pair(JTransformerTransducer, TransformerTransducer, TINY))


@pytest.fixture(scope="module", params=["auto", "xla"])
def runs(request):
    return run_both(request.param, cfg=TINY, jax_cls=JTransformerTransducer, port_cls=TransformerTransducer)


def test_transformer_transducer_step_loss_and_grad_norm_match_jax(runs):
    check_first_step_loss_and_grad_norm(runs)


def test_transformer_transducer_step_every_gradient_matches_jax(runs):
    check_first_step_every_gradient(runs)


def test_transformer_transducer_k_adam_steps_and_batch_stats_match_jax(runs):
    check_k_adam_steps(runs)
    check_batch_stats_round_trip(runs)


def test_transformer_transducer_eval_step_matches_jax(monkeypatch):
    got, ref = eval_both(JTransformerTransducer, TransformerTransducer, TINY, "auto", monkeypatch)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_transformer_transducer_builds_at_published_widths(tmp_path):
    model = check_published_widths("examples/models/transducer/transformer/base.yml.j2", TransformerTransducer, tmp_path)
    enc = model.encoder
    assert (enc.dmodel, enc.num_blocks, model.vocab_size) == (256, 8, 1000)
    assert model.decode_params() is not None  # the fused decode takes the config
