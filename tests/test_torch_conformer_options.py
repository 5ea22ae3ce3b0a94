"""The Conformer encoder under each option of the JAX encoder that the port
took last, against JAX's ``ConformerEncoder``, on the CPU.

One parametrised test, one case per option value: vanilla MHA (absolute
PE, no attention biases; kernel A's plain version), post- and no module
norm, pre- and no block norm, a conv scale of 4, the grouped depthwise
conv (at scale 2 and 4), LayerNorm and no norm after it, no attention
auto mask, and all three residual factors trainable. A tiny encoder (2
blocks, D 16, 4 heads of 4, a 7-tap causal conv, Conv2d ×4 subsampling
with BatchNorm) runs both packages from the same weights (``bridge.py``,
BatchNorm running statistics moved off their init values), f32, dropout
0, over a ragged batch: the inference forward, the training forward
(BatchNorm on batch statistics) with its updated running statistics, and
every parameter's gradient and the input's under one random cotangent.

JAX runs its XLA routes here (``TFASR_FF_IMPL``, ``TFASR_CONV_IMPL`` and
``TFASR_ATTN_IMPL`` = ``xla``): where its fused conditions hold, the
Pallas kernels would compute the same function in interpret mode, which
``tests/test_torch_layers.py``, ``tests/test_torch_vanilla_attention.py``
and the slice tests already hold, at several times the cost. The port takes its own dispatch, which is JAX's condition
for condition (the plain versions of the kernels on the CPU).

Tolerances: forward f32 1e-5 (2e-5 after two blocks of summation-order
noise on unit-scale outputs, as ``tests/test_torch_slice.py`` holds the
encoder); each gradient 1e-4 of its largest magnitude plus 1e-6 of the
largest gradient (the gradients that are zero in exact arithmetic, a conv
bias ahead of a BatchNorm on batch statistics and the attention key bias,
are f32 noise), as ``tests/test_torch_train_slice.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.models.encoders import conformer as jconf
from tensorflowasr_tpu_torch import bridge
from tensorflowasr_tpu_torch.models.encoders import conformer as tconf

SUBSAMPLING = {
    "class_name": "tensorflow_asr.models.layers.subsampling>Conv2dSubsampling",
    "config": {"filters": [8, 8], "kernels": [3, 3], "strides": [2, 2], "paddings": ["causal", "causal"], "norms": ["batch", "batch"],
               "activations": ["swish", "swish"]},
}
BASE = dict(dmodel=16, num_blocks=2, head_size=4, num_heads=4, kernel_size=7, dropout=0.0)
OPTIONS = {
    "mha_type=mha": dict(mha_type="mha"),
    "module_norm_position=post": dict(module_norm_position="post"),
    "module_norm_position=none": dict(module_norm_position="none"),
    "block_norm_position=pre": dict(block_norm_position="pre"),
    "block_norm_position=none": dict(block_norm_position="none"),
    "convm_scale_factor=4": dict(convm_scale_factor=4),
    "convm_use_group_conv": dict(convm_use_group_conv=True),
    "convm_use_group_conv_scale4": dict(convm_use_group_conv=True, convm_scale_factor=4),
    "convm_dw_norm_type=layer": dict(convm_dw_norm_type="layer"),
    "convm_dw_norm_type=none": dict(convm_dw_norm_type="none"),
    "use_attention_auto_mask=False": dict(use_attention_auto_mask=False),
    "residual_factors=trainable": dict(ffm_residual_factor="trainable", mhsam_residual_factor="trainable", convm_residual_factor="trainable"),
}
FWD_TOL = dict(rtol=0, atol=2e-5)
GRAD_REL = 1e-4


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _dispatch(tmod: tconf.ConformerEncoder, option: dict) -> None:
    """The FF and conv modules' route in the port: the fused kernels exactly under JAX's conditions."""
    ff_fused = option.get("module_norm_position", "pre") == "pre" and option.get("ffm_residual_factor", 0.5) != "trainable"
    conv_fused = (option.get("module_norm_position", "pre") == "pre" and option.get("convm_dw_norm_type", "batch") == "batch"
                  and option.get("convm_scale_factor", 2) == 2 and not option.get("convm_use_group_conv", False)
                  and option.get("convm_residual_factor", 1.0) != "trainable")
    blocks = [getattr(tmod, f"block_{i}") for i in range(tmod.num_blocks)]
    assert all(b.ff_module_1.fused == b.ff_module_2.fused == ff_fused and b.conv_module.fused == conv_fused for b in blocks)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_conformer_encoder_option_matches_jax(option, monkeypatch):
    monkeypatch.setenv("TFASR_FF_IMPL", "xla")
    monkeypatch.setenv("TFASR_CONV_IMPL", "xla")
    monkeypatch.setenv("TFASR_ATTN_IMPL", "xla")
    kw = {**BASE, **OPTIONS[option]}
    rng = np.random.default_rng(0)
    feats, lens = _x((3, 41, 20), 1), np.array([41, 30, 13], np.int32)
    jmod = jconf.ConformerEncoder(subsampling=SUBSAMPLING, **kw)
    v = jax.tree_util.tree_map(np.asarray, jmod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(feats), jnp.asarray(lens)))
    v["params"] = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), v["params"])
    v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    tmod = tconf.ConformerEncoder(SUBSAMPLING, 20, **kw)
    tmod.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    _dispatch(tmod, OPTIONS[option])

    ref, ref_len, _ = jmod.apply(v, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        got, got_len, _ = tmod(torch.tensor(feats), torch.tensor(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)

    cot = _x(np.asarray(ref).shape, 2)

    def jloss(params, x):
        (out, _, _), upd = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, x, jnp.asarray(lens), train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd)

    (_, (ref_t, upd)), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(feats))
    tx = torch.tensor(feats, requires_grad=True)
    got_t, _, _ = tmod(tx, torch.tensor(lens), train=True)
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(ref_t), **FWD_TOL)
    (got_t * torch.tensor(cot)).sum().backward()

    ref_g = bridge.state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jg)})
    names = {n for n, _ in tmod.named_parameters()}
    assert names == set(ref_g)
    gmax = max(np.abs(g.numpy()).max() for g in ref_g.values())
    for name, p in tmod.named_parameters():
        r = ref_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0, atol=GRAD_REL * np.abs(r).max() + 1e-6 * gmax, err_msg=name)
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), jgx, rtol=0, atol=GRAD_REL * np.abs(jgx).max())
    stats = bridge.state_dict_from_flax({"params": {}, "batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])})
    for key, val in stats.items():
        np.testing.assert_allclose(tmod.state_dict()[key].numpy(), val.numpy(), rtol=1e-5, atol=1e-6, err_msg=key)
