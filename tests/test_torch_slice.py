"""The port's serving slice end to end on a tiny Conformer-Transducer vs
the JAX model, weights carried by ``bridge.py``, f32 on the CPU.

Encoder outputs agree to summation order (2e-5 absolute on LayerNorm'd,
unit-scale outputs); greedy tokens agree exactly.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.models.transducer import base as jbase
from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu_torch import bridge, schemas
from tensorflowasr_tpu_torch.models.transducer.base import recognize
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_models.py's tiny Conformer-T, with 2 blocks
TINY_CFG = {
    "speech_config": {"sample_rate": 16000, "frame_ms": 25, "stride_ms": 10, "num_feature_bins": 40, "nfft": 512},
    "encoder_subsampling": {
        "class_name": "tensorflow_asr.models.layers.subsampling>Conv2dSubsampling",
        "config": {"filters": [16, 16], "kernels": [3, 3], "strides": [2, 2], "paddings": ["causal", "causal"], "norms": ["batch", "batch"], "activations": ["swish", "swish"]},
    },
    "encoder_dmodel": 16,
    "encoder_num_blocks": 2,
    "encoder_head_size": 4,
    "encoder_num_heads": 4,
    "encoder_mha_type": "relmha",
    "encoder_kernel_size": 7,
    "encoder_dropout": 0.0,
    "prediction_label_encode_mode": "embedding",
    "prediction_embed_dim": 8,
    "prediction_num_rnns": 1,
    "prediction_rnn_units": 16,
    "prediction_rnn_type": "lstm",
    "prediction_layer_norm": True,
    "prediction_projection_units": 0,
    "joint_dim": 16,
    "prejoint_encoder_linear": True,
    "prejoint_prediction_linear": True,
    "joint_activation": "tanh",
    "joint_mode": "add",
    "blank": 0,
    "vocab_size": 20,
}


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    b, n = 3, 8000
    sig = (rng.standard_normal((b, n)) * 0.5).astype(np.float32)
    lens = np.array([n, 5000, 2600], np.int32)
    jm = JConformer.from_config(TINY_CFG)
    ti = jschemas.TrainInput(jnp.asarray(sig), jnp.asarray(lens), jnp.zeros((b, 3), jnp.int32), jnp.full((b,), 3, jnp.int32))
    v = jax.tree_util.tree_map(np.asarray, jm.init({"params": jax.random.PRNGKey(1)}, ti, train=False))
    v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    tm = Conformer.from_config(TINY_CFG, device="cpu")
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    return jm, v, tm.eval(), sig, lens


def test_encoder_matches_jax(models):
    jm, v, tm, sig, lens = models
    ref, ref_len, _ = jm.apply(v, jnp.asarray(sig), jnp.asarray(lens), method=jm.encode)
    with torch.inference_mode():
        got, got_len, _ = tm.encode(torch.tensor(sig), torch.tensor(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("mode", ["wind", "sync"])
def test_greedy_tokens_equal_jax_recognize(models, mode):
    jm, v, tm, sig, lens = models
    kw = {} if mode == "wind" else {"max_symbols_per_frame": 2}  # sync: the reference's per-frame cap
    ref = jbase.recognize(jm, v, jschemas.PredictInput(jnp.asarray(sig), jnp.asarray(lens)), **kw)
    got = recognize(tm, schemas.PredictInput(torch.tensor(sig), torch.tensor(lens)), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.next_tokens.numpy(), np.asarray(ref.next_tokens))
    for g, r in zip(jax.tree_util.tree_leaves(got.next_decoder_states), jax.tree_util.tree_leaves(ref.next_decoder_states)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-5)


def test_wind_equals_sync_greedy(models):
    _, _, tm, sig, lens = models
    inputs = schemas.PredictInput(torch.tensor(sig), torch.tensor(lens))
    wind, sync = recognize(tm, inputs, decode_mode="wind", window=4), recognize(tm, inputs, decode_mode="sync")
    t_enc = tm.encoder.output_length(tm.feature_extraction.get_nframes(sig.shape[1]))
    assert tuple(wind.tokens.shape) == (3, 2 * t_enc + 1)
    torch.testing.assert_close(wind.tokens, sync.tokens, rtol=0, atol=0)
    torch.testing.assert_close(wind.next_tokens, sync.next_tokens, rtol=0, atol=0)
    for w, s in zip(jax.tree_util.tree_leaves(wind.next_decoder_states), jax.tree_util.tree_leaves(sync.next_decoder_states)):
        torch.testing.assert_close(w, s, rtol=0, atol=0)


def test_bf16_model_serves():
    model = Conformer.from_config(TINY_CFG, dtype=torch.bfloat16, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    sig = torch.tensor((np.random.default_rng(2).standard_normal((2, 4000)) * 0.3).astype(np.float32))
    lens = torch.tensor([4000, 2500])
    enc, _, _ = model.encode(sig, lens)
    assert enc.dtype == torch.bfloat16 and torch.isfinite(enc.float()).all()
    out = recognize(model.eval(), schemas.PredictInput(sig, lens))
    assert ((out.tokens >= 0) & (out.tokens < 20)).all()


def test_flagship_config_matches_graft_entry(monkeypatch):
    """``conformer_small_config`` is the dict ``__graft_entry__._conformer_small`` builds."""
    sys.path.insert(0, REPO)
    import __graft_entry__

    captured = {}
    monkeypatch.setattr(JConformer, "from_config", classmethod(lambda cls, config, **kw: captured.setdefault("config", config)))
    __graft_entry__._conformer_small()
    assert conformer_small_config() == captured["config"]
    model = Conformer.from_config(captured["config"], device="cpu")
    assert model.encoder.num_blocks == 16 and model.vocab_size == 256
    assert sum(p.numel() for p in model.parameters()) > 0


def test_unported_options_raise(monkeypatch):
    """The two options that raised until the port took them build and
    match JAX: vanilla MHA's encoder output (absolute PE, kernel A's plain
    version) and a one-hot label encoder's greedy tokens and next decoder
    states. JAX takes its XLA routes for the FF, conv and attention modules
    (the same functions as its Pallas kernels, which the tests above hold)."""
    for name in ("TFASR_FF_IMPL", "TFASR_CONV_IMPL", "TFASR_ATTN_IMPL"):
        monkeypatch.setenv(name, "xla")
    rng = np.random.default_rng(5)
    sig, lens = (rng.standard_normal((2, 6000)) * 0.5).astype(np.float32), np.array([6000, 4100], np.int32)
    for option in ({"encoder_mha_type": "mha"}, {"prediction_label_encode_mode": "one_hot"}):
        cfg = {**TINY_CFG, **option}
        jm = JConformer.from_config(cfg)
        ti = jschemas.TrainInput(jnp.asarray(sig), jnp.asarray(lens), jnp.zeros((2, 3), jnp.int32), jnp.full((2,), 3, jnp.int32))
        v = jax.tree_util.tree_map(np.asarray, jm.init({"params": jax.random.PRNGKey(2)}, ti, train=False))
        tm = Conformer.from_config(cfg, device="cpu")
        tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
        tm.eval()
        ref, _, _ = jm.apply(v, jnp.asarray(sig), jnp.asarray(lens), method=jm.encode)
        with torch.inference_mode():
            got, _, _ = tm.encode(torch.tensor(sig), torch.tensor(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
        ref_out = jbase.recognize(jm, v, jschemas.PredictInput(jnp.asarray(sig), jnp.asarray(lens)))
        out = recognize(tm, schemas.PredictInput(torch.tensor(sig), torch.tensor(lens)))
        np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref_out.tokens))
        for g, r in zip(jax.tree_util.tree_leaves(out.next_decoder_states), jax.tree_util.tree_leaves(ref_out.next_decoder_states)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-5)


def test_port_imports_no_jax_flax_yaml_tokenizers():
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import tensorflowasr_tpu_torch\n"
        "for m in pkgutil.walk_packages(tensorflowasr_tpu_torch.__path__, 'tensorflowasr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'tokenizers', 'jinja2', 'tensorflowasr_tpu'))\n"
        "print(' '.join(sorted(m for m in sys.modules if m.startswith('tensorflowasr_tpu_torch'))))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    assert len(imported) > 25  # every module of the package was imported, the training slice's among them
    assert {f"tensorflowasr_tpu_torch.{m}" for m in ("training.trainer", "optimizers", "ops.rnnt_loss", "ops.dropout", "utils.device")} <= imported
    # chip_smoke.py (which runs where JAX is absent) imports none of it either
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not roots & {"jax", "jaxlib", "flax", "optax", "tensorflowasr_tpu"}, roots
