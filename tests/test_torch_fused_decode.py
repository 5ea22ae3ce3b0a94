"""The fused greedy decode's plain version vs JAX's fused decode kernel
(``scripts_dev/decode_kernel.py``, Pallas in interpret mode), and the
port's ``recognize`` vs JAX's, on the CPU.

Tolerances: at f32 tokens, lengths and next tokens are equal and the
carried LSTM states agree to summation order (rtol 1e-5, atol 1e-6, the
canary's). At bf16 the inputs are sharpened as the canary does (encoder
output ×3, +2 on column 0) so that no decision sits near a tie: tokens are
equal; the states read every product's operands in bf16 on both sides, so
they differ by f32 summation order plus an occasional flipped bf16
rounding of h (one ulp, 2^-8 relative) carried through the cell: atol 1e-2.
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.models.transducer import base as jbase
from tensorflowasr_tpu.models.transducer.base import TransducerJoint as JJoint, TransducerPrediction as JPrediction
from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu_torch import bridge, schemas
from tensorflowasr_tpu_torch.models.transducer import base as tbase
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk
from tests.test_torch_slice import TINY_CFG

_SPEC = importlib.util.spec_from_file_location(
    "jax_fused_decode_kernel", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts_dev", "decode_kernel.py")
)
jdk = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jdk)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the canary's prediction-net configurations (decode_kernel_canary.py:64-68)
CONFIGS = [dict(num_rnns=1, layer_norm=True, proj=0), dict(num_rnns=1, layer_norm=False, proj=8), dict(num_rnns=2, layer_norm=True, proj=11)]


def _build(vocab=16, embed=12, units=10, num_rnns=1, layer_norm=True, proj=0, joint_dim=14, enc_dim=9, seed=0):
    """JAX prediction net and joint (params moved off their init values so
    biases and LayerNorm matter) and the port's copies of them."""
    pc = dict(label_encoder_mode="embedding", embed_dim=embed, num_rnns=num_rnns, rnn_units=units, layer_norm=layer_norm, projection_units=proj)
    jc = dict(joint_dim=joint_dim, activation="tanh", prejoint_encoder_linear=True, prejoint_prediction_linear=True, joint_mode="add")
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    noisy = lambda tree: jax.tree_util.tree_map(lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), tree)
    pv = noisy(JPrediction(blank=0, vocab_size=vocab, **pc).init(k1, jnp.zeros((1, 2), jnp.int32))["params"])
    pdim = proj if proj > 0 else units
    jv = noisy(JJoint(vocab_size=vocab, **jc).init(k2, jnp.zeros((1, 3, enc_dim)), jnp.zeros((1, 2, pdim)))["params"])
    pred = tbase.TransducerPrediction(blank=0, vocab_size=vocab, **pc)
    pred.load_state_dict(bridge.state_dict_from_flax({"params": pv}), strict=True)
    joint = tbase.TransducerJoint(vocab, enc_dim, pdim, **jc)
    joint.load_state_dict(bridge.state_dict_from_flax({"params": jv}), strict=True)
    model = types.SimpleNamespace(prediction_config=pc, joint_config=jc, prediction=pred, joint=joint)
    return pc, jc, {"prediction": pv, "joint": jv}, model


def _sharpen(enc, blank_bias=2.0):
    e = np.array(enc, np.float32)
    e *= 3.0
    e[..., 0] += blank_bias
    return e


def _states(batch, units, layers, rng):
    return tuple((rng.standard_normal((batch, units)).astype(np.float32) * 0.5, rng.standard_normal((batch, units)).astype(np.float32) * 0.5)
                 for _ in range(layers))


def _both(jparams, tparams, enc, lens, tok0, states, window, jdt):
    ref = jdk.fused_greedy_decode(jnp.asarray(enc, jdt), jnp.asarray(lens), jparams, jnp.asarray(tok0), jax.tree_util.tree_map(jnp.asarray, states),
                                  window=window)
    got = dk.fused_greedy_decode(torch.tensor(enc).to(tparams.wv.dtype), torch.tensor(lens), tparams, torch.tensor(tok0),
                                 tuple((torch.tensor(c), torch.tensor(h)) for c, h in states), window=window)
    return ref, got


def _assert_equal_decodes(ref, got, state_tol):
    rt, rl, rn, rs = ref
    gt, gl, gn, gs = got
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))  # past each length both hold blank
    np.testing.assert_array_equal(gn.numpy(), np.asarray(rn))
    for (gc, gh), (rc, rh) in zip(gs, rs):
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc, np.float32), **state_tol)
        np.testing.assert_allclose(gh.numpy(), np.asarray(rh, np.float32), **state_tol)


STATE_TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=0, atol=1e-2)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cfg", CONFIGS, ids=["1lstm_ln", "proj8_noln", "2lstm_ln_proj11"])
def test_plain_matches_jax_fused_decode(cfg, dtype):
    jdt, tdt = DTYPES[dtype]
    pc, jc, params, model = _build(**cfg)
    jparams, tparams = jdk.extract_decode_params(pc, jc, params, jdt), tbase.extract_decode_params(model, tdt)
    rng = np.random.default_rng(1)
    b, t = 3, 12
    enc = _sharpen(rng.standard_normal((b, t, 9)))
    lens = np.array([12, 7, 0], np.int32)
    tok0 = np.array([0, 5, 3], np.int32)
    states = _states(b, 10, cfg["num_rnns"], rng)
    ref, got = _both(jparams, tparams, enc, lens, tok0, states, 4, jdt)
    assert int(got[1].max()) > 2  # the decode emits
    _assert_equal_decodes(ref, got, STATE_TOL[dtype])


def test_plain_streaming_chunks_match_jax_fused_chunks():
    """Chunk by chunk, the carried (token, states) of the plain version equal
    JAX's fused kernel's at every boundary (decode_kernel_canary.py:97-119)."""
    pc, jc, params, model = _build(num_rnns=1, layer_norm=True, proj=0)
    jparams, tparams = jdk.extract_decode_params(pc, jc, params), tbase.extract_decode_params(model)
    enc = _sharpen(np.random.default_rng(2).standard_normal((1, 16, 9)), blank_bias=3.0)
    jtok, jst = np.zeros((1,), np.int32), _states(1, 10, 1, np.random.default_rng(3))
    ttok, tst = torch.tensor(jtok), tuple((torch.tensor(c), torch.tensor(h)) for c, h in jst)
    jst = jax.tree_util.tree_map(jnp.asarray, jst)
    emitted = 0
    for lo, hi in ((0, 6), (6, 16)):
        chunk, clen = enc[:, lo:hi], np.array([hi - lo], np.int32)
        rt, rl, jtok, jst = jdk.fused_greedy_decode(jnp.asarray(chunk), jnp.asarray(clen), jparams, jtok, jst, window=4)
        gt, gl, ttok, tst = dk.fused_greedy_decode(torch.tensor(chunk), torch.tensor(clen), tparams, ttok, tst, window=4)
        _assert_equal_decodes((rt, rl, jtok, jst), (gt, gl, ttok, tst), STATE_TOL["f32"])
        emitted += int(gl[0])
    assert emitted > 0


@pytest.mark.parametrize("pc,jc", [
    (dict(label_encoder_mode="one_hot", num_rnns=1, rnn_units=8), dict(joint_dim=8)),
    (dict(label_encoder_mode="embedding", rnn_type="gru"), dict(joint_dim=8)),
    (dict(label_encoder_mode="embedding"), dict(joint_dim=8, joint_mode="mul")),
    (dict(label_encoder_mode="embedding"), dict(joint_dim=8, activation="relu")),
    (dict(label_encoder_mode="embedding"), dict(joint_dim=8, postjoint_linear=True)),
    (dict(label_encoder_mode="embedding"), dict(joint_dim=8, prejoint_prediction_linear=False)),
], ids=["one_hot", "gru", "mul_joint", "relu_joint", "postjoint", "no_prejoint"])
def test_unsupported_configs_return_none(pc, jc):
    """The JAX kernel's exclusions (decode_kernel.py:100-109), read from the configs alone."""
    assert jdk.extract_decode_params(pc, jc, {}) is None
    assert tbase.extract_decode_params(types.SimpleNamespace(prediction_config=pc, joint_config=jc)) is None


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    b, n = 3, 8000
    sig = (rng.standard_normal((b, n)) * 0.5).astype(np.float32)
    lens = np.array([n, 5000, 2600], np.int32)
    jm = JConformer.from_config(TINY_CFG)
    ti = jschemas.TrainInput(jnp.asarray(sig), jnp.asarray(lens), jnp.zeros((b, 3), jnp.int32), jnp.full((b,), 3, jnp.int32))
    v = jax.tree_util.tree_map(np.asarray, jm.init({"params": jax.random.PRNGKey(3)}, ti, train=False))
    v["params"]["joint"]["vocab"]["kernel"] = v["params"]["joint"]["vocab"]["kernel"] * 4.0  # decisive argmaxes
    tm = Conformer.from_config(TINY_CFG, device="cpu")
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    return jm, v, tm.eval(), sig, lens


def test_recognize_takes_the_fused_decode_and_equals_jax(tiny, monkeypatch):
    """Port ``recognize`` (CPU: the fused decode's plain version) vs JAX
    ``recognize`` (the XLA WIND loop): tokens, next tokens equal; states to
    summation order."""
    jm, v, tm, sig, lens = tiny
    calls = []
    plain = dk.fused_greedy_decode_plain
    monkeypatch.setattr(dk, "fused_greedy_decode_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    ref = jbase.recognize(jm, v, jschemas.PredictInput(jnp.asarray(sig), jnp.asarray(lens)))
    got = tbase.recognize(tm, schemas.PredictInput(torch.tensor(sig), torch.tensor(lens)))
    assert calls == [1]
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.next_tokens.numpy(), np.asarray(ref.next_tokens))
    for g, r in zip(jax.tree_util.tree_leaves(got.next_decoder_states), jax.tree_util.tree_leaves(ref.next_decoder_states)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=2e-5)


def test_recognize_keeps_the_eager_loop_where_the_kernel_does_not_apply(tiny):
    """A mul joint is outside the kernel's support: ``recognize`` decodes it
    through the eager WIND loop, and its tokens equal JAX's."""
    jm, v, _, sig, lens = tiny
    cfg = {**TINY_CFG, "joint_mode": "mul"}
    jmul = JConformer.from_config(cfg)
    tmul = Conformer.from_config(cfg, device="cpu")
    tmul.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    assert tmul.decode_params() is None
    ref = jbase.recognize(jmul, v, jschemas.PredictInput(jnp.asarray(sig), jnp.asarray(lens)))
    got = tbase.recognize(tmul.eval(), schemas.PredictInput(torch.tensor(sig), torch.tensor(lens)))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))


def test_decode_params_cache_follows_the_weights():
    """The cached kernel weights (bf16 copies of the f32 parameters) are
    rebuilt after ``reset_parameters`` and ``load_state_dict``."""
    model = Conformer.from_config(TINY_CFG, dtype=torch.bfloat16, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    first = model.decode_params()
    assert model.decode_params() is first and first.wv.dtype == torch.bfloat16
    model.reset_parameters(torch.Generator().manual_seed(1))
    second = model.decode_params()
    assert not torch.equal(second.wv, first.wv)
    torch.testing.assert_close(second.wv, model.joint.vocab.weight.to(torch.bfloat16), rtol=0, atol=0)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["prediction.rnn_0.cell.weight_hh"] += 1.0
    model.load_state_dict(state)
    torch.testing.assert_close(model.decode_params().layers[0].w_hh, state["prediction.rnn_0.cell.weight_hh"].to(torch.bfloat16), rtol=0, atol=0)


def test_kernel_wrapper_refuses_other_devices():
    _, _, _, model = _build()
    params = tbase.extract_decode_params(model)
    enc = torch.zeros(1, 3, 9, device="meta")
    with pytest.raises(ValueError, match="no decode kernel"):
        dk.fused_greedy_decode(enc, torch.tensor([3]), params, torch.tensor([0]), ((torch.zeros(1, 10), torch.zeros(1, 10)),))
