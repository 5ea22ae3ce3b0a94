"""Training-mode layers of the port vs the JAX layers, weights carried by
``bridge.py``, f32 on the CPU: BatchNorm on batch statistics with the
flax running-statistics update, the conv module's batch statistics, and the
prediction and joint networks over whole sequences.

Tolerances: summation order, 1e-5 absolute and relative on unit-scale
outputs and statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.models.encoders import conformer as jconf
from tensorflowasr_tpu.models.layers import subsampling as jsub
from tensorflowasr_tpu.models.transducer import base as jbase
from tensorflowasr_tpu_torch import bridge
from tensorflowasr_tpu_torch.models.encoders import conformer as tconf
from tensorflowasr_tpu_torch.models.layers import subsampling as tsub
from tensorflowasr_tpu_torch.models.transducer import base as tbase
from tests.test_torch_layers import _init, _load, _x

TOL = dict(rtol=1e-5, atol=1e-5)


def _stats_close(module, variables, new_stats):
    """The port module's running statistics equal JAX's updated ``batch_stats``."""
    got = bridge.batch_stats_to_flax(module.state_dict(), variables["batch_stats"])
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(new_stats)):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
    moved = [not np.allclose(a, b) for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(variables["batch_stats"]))]
    assert all(moved)


def test_conv2d_subsampling_train_batch_stats():
    kw = dict(strides=((2, 2), (2, 2)), kernels=((3, 3), (3, 3)), paddings=("causal", "causal"), norms=("batch", "batch"), activations=("swish", "swish"))
    jmod = jsub.Conv2dSubsampling(filters=(8, 6), **kw)
    x, lens = _x((2, 17, 20, 1)), np.array([17, 9], np.int32)
    v = _init(jmod, jnp.asarray(x), jnp.asarray(lens))
    (ref, _), mutated = jmod.apply(v, jnp.asarray(x), jnp.asarray(lens), train=True, mutable=["batch_stats"])
    tmod = _load(tsub.Conv2dSubsampling(20, filters=(8, 6), **kw), v)
    got, _ = tmod(torch.tensor(x), torch.tensor(lens), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    _stats_close(tmod, v, mutated["batch_stats"])


@pytest.mark.parametrize("padding", ["causal", "same"])
def test_conv_module_train_batch_stats_and_grad(padding):
    x = _x((2, 11, 16))
    jmod = jconf.ConvModule(input_dim=16, kernel_size=7, padding=padding)
    v = _init(jmod, jnp.asarray(x))
    w = _x((2, 11, 16), seed=9)

    def jloss(xx):
        out, mutated = jmod.apply(v, xx, train=True, mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(w)), (out, mutated["batch_stats"])

    (_, (ref, new_stats)), ref_dx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    tmod = _load(tconf.ConvModule(16, kernel_size=7, padding=padding), v)
    tx = torch.tensor(x, requires_grad=True)
    got = tmod(tx, train=True, generator=torch.Generator().manual_seed(0))
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=1e-4)  # through the batch statistics
    _stats_close(tmod, v, new_stats)


def test_prediction_network_over_sequences():
    kw = dict(blank=0, vocab_size=12, embed_dim=6, num_rnns=2, rnn_units=10, projection_units=7)
    jmod = jbase.TransducerPrediction(**kw)
    tokens = np.random.default_rng(3).integers(0, 12, (3, 6)).astype(np.int32)
    lens = np.array([6, 3, 1], np.int32)
    v = _init(jmod, jnp.asarray(tokens), jnp.asarray(lens))
    ref = jmod.apply(v, jnp.asarray(tokens), jnp.asarray(lens))
    got = _load(tbase.TransducerPrediction(**kw), v)(torch.tensor(tokens), torch.tensor(lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)  # padded positions included


@pytest.mark.parametrize("joint_mode,postjoint", [("add", False), ("mul", True)])
def test_joint_over_the_lattice(joint_mode, postjoint):
    kw = dict(joint_dim=9, joint_mode=joint_mode, postjoint_linear=postjoint)
    jmod = jbase.TransducerJoint(vocab_size=11, **kw)
    enc, pred = _x((2, 3, 5)), _x((2, 4, 6), seed=2)
    v = _init(jmod, jnp.asarray(enc), jnp.asarray(pred))
    ref = jmod.apply(v, jnp.asarray(enc), jnp.asarray(pred))
    got = _load(tbase.TransducerJoint(11, 5, 6, **kw), v)(torch.tensor(enc), torch.tensor(pred))
    assert tuple(got.shape) == (2, 3, 4, 11)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
