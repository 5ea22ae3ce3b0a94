"""The port's Keras ``.weights.h5`` converter vs the JAX package's, on the CPU.

A synthetic reference checkpoint is written with ``h5py``: for every leaf
of a tiny JAX Conformer-Transducer (2 blocks, width 16), random values in
the Keras layout at the dataset path that JAX's own key map
(``convert/keras_h5.py:_transducer_ref_entry``) names: depthwise kernels
``[k, C, 1]``, LSTM kernels fused over the four gates, BatchNorm's four
vars. Then:

- JAX ``load_transducer_h5`` carried through ``bridge.state_dict_from_flax``
  equals the port's ``load_transducer_h5`` exactly, entry by entry;
- the port's forward on the converted weights equals JAX's on its own
  within 2e-5 (f32);
- a file without the prediction and joint networks raises under
  ``strict``, and without it keeps those entries as the model has them;
- ``utils convert_checkpoint --device cpu`` writes the converter's
  ``state_dict`` to a file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.convert import keras_h5 as jkeras
from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu_torch import bridge, schemas
from tensorflowasr_tpu_torch.convert import load_transducer_h5
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tests.test_torch_slice import TINY_CFG

h5py = pytest.importorskip("h5py")

VOCAB = "abcdefghijklmnopqrst"  # TINY_CFG's 20 classes


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _write_reference_h5(path, variables, seed):
    """Random Keras-layout values at the h5 path of every JAX leaf."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for key, value in _flat(jax.tree_util.tree_map(np.asarray, variables)).items():
        h5_path, tag = jkeras._transducer_ref_entry(key)
        if tag == "dwconv":
            shape = (value.shape[0], value.shape[2], 1)
        elif tag is not None and tag.startswith("lstm_"):
            shape = value.shape[:-1] + (4 * value.shape[-1],)
        else:
            shape = value.shape
        if h5_path not in arrays:
            arr = rng.standard_normal(shape) * 0.2
            arrays[h5_path] = (np.abs(arr) + 0.5 if key.endswith("/var") else arr).astype(np.float32)
    with h5py.File(path, "w") as f:
        for h5_path, arr in arrays.items():
            f.create_dataset(h5_path, data=arr)


def _jax_model(vocab_size=20):
    jm = JConformer.from_config({**TINY_CFG, "vocab_size": vocab_size})
    ti = jschemas.TrainInput(jnp.zeros((1, 3200)), jnp.asarray([3200]), jnp.zeros((1, 3), jnp.int32), jnp.full((1,), 3, jnp.int32))
    return jm, jax.jit(lambda key: jm.init({"params": key}, ti, train=False))(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    jm, init = _jax_model()
    path = str(tmp_path_factory.mktemp("h5") / "ref.weights.h5")
    _write_reference_h5(path, init, seed=3)
    jvars = jkeras.load_transducer_h5(path, init)
    return {"path": path, "jm": jm, "jvars": jvars}


def test_converter_equals_jax_then_bridge(reference):
    tm = Conformer.from_config(TINY_CFG, device="cpu")
    got = load_transducer_h5(reference["path"], tm)
    ref = bridge.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, reference["jvars"]))
    assert set(got) == set(ref) == set(tm.state_dict())
    for key, value in ref.items():
        assert torch.equal(got[key], value), key


def test_converted_forward_matches_jax(reference):
    tm = Conformer.from_config(TINY_CFG, device="cpu")
    tm.load_state_dict(load_transducer_h5(reference["path"], tm), strict=True)
    rng = np.random.default_rng(4)
    sig = (rng.standard_normal((2, 3200)) * 0.3).astype(np.float32)
    lens = np.array([3200, 2100], np.int32)
    preds = np.pad(rng.integers(1, 20, (2, 4)), ((0, 0), (1, 0))).astype(np.int32)
    plens = np.array([5, 3], np.int32)
    jm, jvars = reference["jm"], reference["jvars"]
    ref = jax.jit(lambda v_, ti: jm.apply(v_, ti, train=False))(jvars, jschemas.TrainInput(*(jnp.asarray(a) for a in (sig, lens, preds, plens))))
    with torch.no_grad():
        got = tm.eval()(schemas.TrainInput(*(torch.tensor(a) for a in (sig, lens, preds, plens))))
    np.testing.assert_array_equal(got.logits_length.numpy(), np.asarray(ref.logits_length))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), rtol=1e-5, atol=2e-5)


def test_truncated_h5_raises_under_strict(reference, tmp_path):
    trunc = str(tmp_path / "trunc.weights.h5")
    with h5py.File(reference["path"], "r") as src, h5py.File(trunc, "w") as dst:
        src.copy("encoder", dst)  # drops joint_net and the prediction network
    tm = Conformer.from_config(TINY_CFG, device="cpu")
    tm.reset_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unmapped|missing"):
        load_transducer_h5(trunc, tm)
    kept = load_transducer_h5(trunc, tm, strict=False)
    assert torch.equal(kept["joint.vocab.weight"], tm.state_dict()["joint.vocab.weight"])
    full = load_transducer_h5(reference["path"], tm)
    assert torch.equal(kept["encoder.linear.weight"], full["encoder.linear.weight"])


def test_convert_checkpoint_cli(reference, tmp_path):
    import yaml

    from tensorflowasr_tpu_torch.scripts import main

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("".join(f"{c}\n" for c in VOCAB))
    model_cfg = {k: v for k, v in TINY_CFG.items() if k != "vocab_size"}
    config = tmp_path / "config.yml"
    config.write_text(yaml.safe_dump({"decoder_config": {"type": "characters", "blank_index": 0, "vocabulary": str(vocab)},
                                      "model_config": {"class_name": "Conformer", "config": model_cfg}, "data_config": {}}))
    out = tmp_path / "converted" / "model.pt"
    assert main(["utils", "convert_checkpoint", "--config-path", str(config), "--h5", reference["path"], "--output", str(out), "--device", "cpu"]) == 0
    saved = torch.load(out, weights_only=True)
    tm = Conformer.from_config(TINY_CFG, device="cpu")
    ref = load_transducer_h5(reference["path"], tm)
    assert set(saved) == set(ref) and all(torch.equal(saved[k], v) for k, v in ref.items())
