"""Port layers vs the JAX layers, weights carried by ``bridge.py``.

f32 tolerances are summation-order tolerances (1e-5 absolute on
unit-scale outputs). The JAX modules take their CPU dispatch, which runs
the Pallas kernels in interpret mode for FF, conv and attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.models.encoders import conformer as jconf
from tensorflowasr_tpu.models.layers import convolution as jconv
from tensorflowasr_tpu.models.layers import positional as jpos
from tensorflowasr_tpu.models.layers import rnn as jrnn
from tensorflowasr_tpu.models.layers import subsampling as jsub
from tensorflowasr_tpu.models.transducer import base as jbase
from tensorflowasr_tpu_torch import bridge
from tensorflowasr_tpu_torch.models.encoders import conformer as tconf
from tensorflowasr_tpu_torch.models.layers import convolution as tconv
from tensorflowasr_tpu_torch.models.layers import positional as tpos
from tensorflowasr_tpu_torch.models.layers import rnn as trnn
from tensorflowasr_tpu_torch.models.layers import subsampling as tsub
from tensorflowasr_tpu_torch.models.transducer import base as tbase

TOL = dict(rtol=1e-5, atol=1e-5)


def _init(module, *args, seed=0, **kwargs):
    """JAX variables as numpy, batch stats moved off their init values so
    the running statistics matter."""
    v = jax.tree_util.tree_map(np.asarray, module.init({"params": jax.random.PRNGKey(seed)}, *args, **kwargs))
    rng = np.random.default_rng(seed)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    if "params" in v:
        v["params"] = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), v["params"])
    return v


def _load(module, variables):
    module.load_state_dict(bridge.state_dict_from_flax(variables), strict=True)
    return module.eval()


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


CONV_CASES = [(kind, padding, stride) for kind in ("conv1d", "depthwise1d", "conv2d") for padding in ("causal", "same", "valid") for stride in (1, 2)]
CONV_CASES += [("conv1d_dilated", padding, 1) for padding in ("causal", "same", "valid")]


@pytest.mark.parametrize("kind,padding,stride", CONV_CASES)
def test_convolutions_padding_semantics(kind, padding, stride):
    if kind == "conv2d":
        x = _x((2, 9, 11, 3))
        jmod = jconv.Conv2D(filters=4, kernel_size=(3, 2), strides=(stride, stride), padding=padding)
        tmod = tconv.Conv2D(3, 4, (3, 2), (stride, stride), padding)
    elif kind.startswith("conv1d"):
        x = _x((2, 9, 3))
        dil = 2 if kind == "conv1d_dilated" else 1
        jmod = jconv.Conv1D(filters=4, kernel_size=3, strides=stride, padding=padding, dilation=dil)
        tmod = tconv.Conv1D(3, 4, 3, stride, padding, dilation=dil)
    else:
        x = _x((2, 9, 3))
        jmod = jconv.DepthwiseConv1D(kernel_size=4, strides=stride, padding=padding)
        tmod = tconv.DepthwiseConv1D(3, 4, stride, padding)
    v = _init(jmod, jnp.asarray(x))
    ref = jmod.apply(v, jnp.asarray(x))
    got = _load(tmod, v)(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("freq", [20, 21])
def test_conv2d_subsampling_causal_freq_pad(freq):
    kw = dict(strides=((2, 2), (2, 2)), kernels=((3, 3), (3, 3)), paddings=("causal", "causal"), norms=("batch", "batch"), activations=("swish", "swish"))
    jmod = jsub.Conv2dSubsampling(filters=(8, 6), **kw)
    x, lens = _x((2, 17, freq, 1)), np.array([17, 9], np.int32)
    v = _init(jmod, jnp.asarray(x), jnp.asarray(lens))
    ref, ref_len = jmod.apply(v, jnp.asarray(x), jnp.asarray(lens))
    tmod = _load(tsub.Conv2dSubsampling(freq, filters=(8, 6), **kw), v)
    got, got_len = tmod(torch.tensor(x), torch.tensor(lens))
    assert tmod.output_dim == ref.shape[-1]
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("interleave,causal", [(True, False), (False, False), (True, True)])
def test_relative_positional_encoding(interleave, causal):
    x, lens = _x((3, 9, 12)), np.array([9, 4, 1], np.int32)
    jmod = jpos.RelativeSinusoidalPositionalEncoding(interleave=interleave, causal=causal)
    _, ref = jmod.apply({}, jnp.asarray(x), jnp.asarray(lens))
    _, got = tpos.RelativeSinusoidalPositionalEncoding(interleave=interleave, causal=causal)(torch.tensor(x), torch.tensor(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_ff_module():
    x = _x((2, 11, 16))
    jmod = jconf.FFModule(input_dim=16)
    v = _init(jmod, jnp.asarray(x))
    ref = jmod.apply(v, jnp.asarray(x))
    got = _load(tconf.FFModule(16), v)(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("padding", ["causal", "same"])
def test_conv_module(padding):
    x = _x((2, 11, 16))
    jmod = jconf.ConvModule(input_dim=16, kernel_size=7, padding=padding)
    v = _init(jmod, jnp.asarray(x))
    ref = jmod.apply(v, jnp.asarray(x))
    got = _load(tconf.ConvModule(16, kernel_size=7, padding=padding), v)(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def _relpe(x, lens):
    return jpos.RelativeSinusoidalPositionalEncoding(interleave=True).apply({}, jnp.asarray(x), jnp.asarray(lens))[1]


@pytest.mark.parametrize("causal_mask", [False, True])
def test_mhsa_module(causal_mask):
    x, lens = _x((2, 10, 16)), np.array([10, 6], np.int32)
    relpe = _relpe(x, lens)
    mask = jnp.arange(10)[None, :] < jnp.asarray(lens)[:, None]
    cb, pb = _x((4, 4), seed=5, scale=0.3), _x((4, 4), seed=6, scale=0.3)
    jmod = jconf.MHSAModule(dmodel=16, head_size=4, num_heads=4)
    kwargs = dict(mask=mask, content_attention_bias=jnp.asarray(cb), positional_attention_bias=jnp.asarray(pb), use_causal_mask=causal_mask)
    v = _init(jmod, jnp.asarray(x), relpe, **kwargs)
    ref, _ = jmod.apply(v, jnp.asarray(x), relpe, **kwargs)
    tmod = _load(tconf.MHSAModule(16, 4, 4), v)
    got, _ = tmod(torch.tensor(x), torch.tensor(np.asarray(relpe)), mask=torch.tensor(np.asarray(mask)), content_attention_bias=torch.tensor(cb),
               positional_attention_bias=torch.tensor(pb), use_causal_mask=causal_mask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_conformer_block_bf16():
    """The bf16 policy (bf16 compute, f32 params and statistics) through a
    whole block: within a few bf16 ulps of the JAX block's output."""
    x, lens = _x((2, 10, 16)), np.array([10, 6], np.int32)
    relpe = _relpe(x, lens)
    mask = jnp.arange(10)[None, :] < jnp.asarray(lens)[:, None]
    jmod = jconf.ConformerBlock(input_dim=16, head_size=4, num_heads=4, kernel_size=7, dtype=jnp.bfloat16)
    v = _init(jmod, jnp.asarray(x, jnp.bfloat16), relpe.astype(jnp.bfloat16), mask)
    ref, _ = jmod.apply(v, jnp.asarray(x, jnp.bfloat16), relpe.astype(jnp.bfloat16), mask)
    tmod = _load(tconf.ConformerBlock(16, head_size=4, num_heads=4, kernel_size=7, dtype=torch.bfloat16), v)
    got, _ = tmod(torch.tensor(x).bfloat16(), torch.tensor(np.asarray(relpe)).bfloat16(), torch.tensor(np.asarray(mask)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(ref, np.float32), rtol=0, atol=2 ** -4)  # 4 bf16 ulps below |x| = 4


def test_lstm_step_and_sequence():
    x, lens = _x((2, 5, 8)), np.array([5, 3], np.int32)
    jmod = jrnn.RNN(units=16)
    v = _init(jmod, jnp.asarray(x))
    tmod = _load(trnn.RNN(8, 16), v)
    state = (_x((2, 16), seed=3), _x((2, 16), seed=4))
    ref_y, ref_state = jmod.apply(v, jnp.asarray(x[:, 0]), tuple(jnp.asarray(s) for s in state), method=jmod.step)
    got_y, got_state = tmod.step(torch.tensor(x[:, 0]), tuple(torch.tensor(s) for s in state))
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(ref_y), **TOL)
    for g, r in zip(got_state, ref_state):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **TOL)
    ref_seq, ref_carry = jmod.apply(v, jnp.asarray(x), jnp.asarray(lens))
    got_seq, got_carry = tmod(torch.tensor(x), torch.tensor(lens))
    valid = np.arange(5)[None, :] < lens[:, None]
    np.testing.assert_allclose(got_seq.detach().numpy()[valid], np.asarray(ref_seq)[valid], **TOL)
    for g, r in zip(got_carry, ref_carry):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **TOL)


def test_prediction_step_with_projection_and_two_lstms():
    kw = dict(blank=0, vocab_size=12, embed_dim=6, num_rnns=2, rnn_units=10, projection_units=7)
    jmod = jbase.TransducerPrediction(**kw)
    token = np.array([3, 11], np.int32)
    states = tuple((_x((2, 10), seed=10 + i), _x((2, 10), seed=20 + i)) for i in range(2))
    jstates = jax.tree_util.tree_map(jnp.asarray, states)
    v = _init(jmod, jnp.asarray(token), jstates, method=jmod.step)
    tmod = _load(tbase.TransducerPrediction(**kw), v)
    ref, ref_states = jmod.apply(v, jnp.asarray(token), jstates, method=jmod.step)
    got, got_states = tmod.step(torch.tensor(token), jax.tree_util.tree_map(torch.tensor, states))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    for g, r in zip(jax.tree_util.tree_leaves(got_states), jax.tree_util.tree_leaves(ref_states)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("joint_mode,postjoint", [("add", False), ("mul", True)])
def test_joint_step(joint_mode, postjoint):
    kw = dict(joint_dim=9, joint_mode=joint_mode, postjoint_linear=postjoint)
    jmod = jbase.TransducerJoint(vocab_size=11, **kw)
    enc, pred = _x((2, 3, 5)), _x((2, 4, 6), seed=2)
    v = _init(jmod, jnp.asarray(enc[:, 0]), jnp.asarray(pred[:, 0]), method=jmod.step)
    ref = jmod.apply(v, jnp.asarray(enc[:, 0]), jnp.asarray(pred[:, 0]), method=jmod.step)
    got = _load(tbase.TransducerJoint(11, 5, 6, **kw), v).step(torch.tensor(enc[:, 0]), torch.tensor(pred[:, 0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
