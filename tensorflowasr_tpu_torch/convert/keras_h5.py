"""Reference Keras-3 ``.weights.h5`` → the port's ``state_dict`` (counterpart
of ``tensorflowasr_tpu/convert/keras_h5.py``).

The reference saves checkpoints with Keras ``save_weights``: an HDF5 tree
of ``<layer path>/vars/<n>`` datasets. :func:`load_transducer_h5` maps
them onto a Conformer-Transducer in two steps: the JAX package's key map
(:func:`_transducer_ref_entry`, copied) from each flax leaf to its h5
dataset, with its layout changes:

  - DepthwiseConv1D kernels: Keras ``[k, C, 1]`` → flax ``[k, 1, C]``;
  - fused LSTM kernels: Keras ``[in, 4u]``/``[u, 4u]``/``[4u]`` with gate
    order (i, f, g, o) → flax's per-gate ``ii/if/ig/io`` (input, no bias)
    and ``hi/hf/hg/ho`` (recurrent, with the bias);
  - BatchNorm: Keras vars (gamma, beta, moving_mean, moving_var) → params
    ``scale``/``bias`` and batch_stats ``mean``/``var``;

then the port's own flax → ``state_dict`` rules (``bridge.state_dict_from_flax``).
The flax leaves are named from the port model's ``state_dict`` (the
inverse of the bridge's naming; the bridge drops the unnamed inner scopes
that the key map never reads), so no JAX is needed.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from tensorflowasr_tpu_torch import bridge

_BN_IDX = {"scale": 0, "bias": 1, "mean": 2, "var": 3}
_LN_IDX = {"scale": 0, "bias": 1}
_DENSE_IDX = {"kernel": 0, "bias": 1}
_GATE_OFFSET = {"i": 0, "f": 1, "g": 2, "o": 3}  # Keras fused gate order
_MHA_NAMES = {
    "query": "query_dense",
    "key": "key_dense",
    "value": "value_dense",
    "encoding": "_relpe_dense",
    "output": "output_dense",
}
_STATS = {"running_mean": "mean", "running_var": "var"}


def read_h5_arrays(path: str) -> dict[str, np.ndarray]:
    """Flatten a Keras .weights.h5 file into {"/layer/path/vars/0": array}."""
    import h5py

    out: dict[str, np.ndarray] = {}

    def walk(group, prefix=""):
        for k, v in group.items():
            p = f"{prefix}/{k}"
            if isinstance(v, h5py.Group):
                walk(v, p)
            else:
                out[p] = np.asarray(v)

    with h5py.File(path, "r") as f:
        walk(f)
    return out


def _sfx(i: int) -> str:
    return "" if i == 0 else f"_{i}"


class _Unmapped(Exception):
    pass


def _transducer_ref_entry(key: str) -> tuple[str, Optional[str]]:
    """Map one flax flat key → (h5 dataset path, special transform tag).

    ``key`` looks like "params/encoder/block_0/mhsa_module/mhsa/query/kernel".
    Returns transform tag in {None, "dwconv", "relmha", "lstm_<gate>"}.
    """
    parts = key.split("/")[1:]  # past the collection (params or batch_stats)
    leaf = parts[-1]

    if parts[0] == "encoder":
        if parts[1] == "subsampling":
            m = re.fullmatch(r"(conv|norm)_(\d+)", parts[2])
            if not m:
                raise _Unmapped(key)
            i = int(m.group(2))
            seq = f"/encoder/conv_subsampling/convs/sequential{_sfx(i)}/layers"
            if m.group(1) == "conv":
                return f"{seq}/conv2d/vars/{_DENSE_IDX[leaf]}", None
            return f"{seq}/batch_normalization/vars/{_BN_IDX[leaf]}", None
        if parts[1] == "linear":
            return f"/encoder/layers/dense/vars/{_DENSE_IDX[leaf]}", None
        if parts[1] == "content_attention_bias":
            return "/encoder/vars/0", None
        if parts[1] == "positional_attention_bias":
            return "/encoder/vars/1", None
        m = re.fullmatch(r"block_(\d+)", parts[1])
        if m:
            base = f"/encoder/conformer_blocks/conformer_block{_sfx(int(m.group(1)))}"
            mod = parts[2]
            fm = re.fullmatch(r"ff_module_(\d)", mod)
            if fm:
                n = fm.group(1)
                if parts[3] == "ln":
                    return f"{base}/ffm{n}/layers/layer_normalization/vars/{_LN_IDX[leaf]}", None
                dm = re.fullmatch(r"dense_(\d)", parts[3])
                if dm:
                    return f"{base}/ffm{n}/ffn{dm.group(1)}/vars/{_DENSE_IDX[leaf]}", None
            if mod == "mhsa_module":
                if parts[3] == "ln":
                    return f"{base}/layers/mhsa_module/layers/layer_normalization/vars/{_LN_IDX[leaf]}", None
                if parts[3] == "mhsa":
                    name = _MHA_NAMES[parts[4]]
                    return (
                        f"{base}/layers/mhsa_module/layers/multi_head_relative_attention/{name}/vars/{_DENSE_IDX[leaf]}",
                        "relmha",
                    )
            if mod == "conv_module":
                if parts[3] == "ln":
                    return f"{base}/convm/layers/layer_normalization/vars/{_LN_IDX[leaf]}", None
                if parts[3] == "pw_conv_1":
                    return f"{base}/convm/layers/conv1d/vars/{_DENSE_IDX[leaf]}", None
                if parts[3] == "pw_conv_2":
                    return f"{base}/convm/layers/conv1d_1/vars/{_DENSE_IDX[leaf]}", None
                if parts[3] == "dw_conv":
                    return f"{base}/convm/dw_conv/vars/{_DENSE_IDX[leaf]}", ("dwconv" if leaf == "kernel" else None)
                if parts[3] == "dw_norm":
                    return f"{base}/convm/dw_norm/vars/{_BN_IDX[leaf]}", None
            if mod == "ln_post":
                return f"{base}/layers/layer_normalization/vars/{_LN_IDX[leaf]}", None
        raise _Unmapped(key)

    if parts[0] == "prediction":
        base = "/layers/transducer_prediction"
        if parts[1] == "embedding":
            return f"{base}/label_encoder/vars/0", None
        m = re.fullmatch(r"ln_(\d+)", parts[1])
        if m:
            return f"{base}/lns/layer_normalization{_sfx(int(m.group(1)))}/vars/{_LN_IDX[leaf]}", None
        m = re.fullmatch(r"rnn_(\d+)", parts[1])
        if m:
            lstm = f"{base}/rnns/lstm{_sfx(int(m.group(1)))}/cell/vars"
            gate_name = parts[3]  # ii/if/ig/io or hi/hf/hg/ho
            gate = gate_name[1]
            if gate_name[0] == "i":  # input kernel, slice of fused vars/0
                return f"{lstm}/0", f"lstm_{gate}"
            if leaf == "kernel":  # recurrent kernel, slice of vars/1
                return f"{lstm}/1", f"lstm_{gate}"
            return f"{lstm}/2", f"lstm_{gate}"  # bias, slice of vars/2
        raise _Unmapped(key)

    if parts[0] == "joint":
        name = {"enc": "ffn_enc", "pred": "ffn_pred", "vocab": "ffn_out"}[parts[1]]
        return f"/joint_net/{name}/vars/{_DENSE_IDX[leaf]}", None

    raise _Unmapped(key)


def _flax_keys(model: torch.nn.Module) -> dict[str, list[str]]:
    """Each ``state_dict`` entry of ``model`` → the flax flat keys whose
    values ``bridge.state_dict_from_flax`` turns into it (an LSTM cell's
    weight into four per-gate leaves)."""
    embeddings = {f"{name}.weight" for name, m in model.named_modules() if isinstance(m, torch.nn.Embedding)}
    out = {}
    for key, value in model.state_dict().items():
        *path, leaf = key.split(".")
        scope = "/".join(path)
        if path and path[-1] in bridge._CELLS:
            kind, name = {"weight_ih": ("i", "kernel"), "weight_hh": ("h", "kernel"), "bias": ("h", "bias")}[leaf]
            out[key] = [f"params/{scope}/{kind}{g}/{name}" for g in bridge._GATES]
        elif leaf in _STATS:
            out[key] = [f"batch_stats/{scope}/{_STATS[leaf]}"]
        elif leaf == "weight":
            name = "embedding" if key in embeddings else ("scale" if value.dim() == 1 else "kernel")
            out[key] = [f"params/{scope}/{name}"]
        else:
            out[key] = [f"params/{scope}/{leaf}"]
    return out


def _h5_value(key: str, weights: dict) -> Optional[np.ndarray]:
    """The flax-layout value of one flax key from the h5 arrays, or None when unmapped or absent."""
    try:
        path, tag = _transducer_ref_entry(key)
    except (_Unmapped, KeyError):
        return None
    if tag == "relmha" and path not in weights:
        path = path.replace("multi_head_relative_attention", "multi_head_attention")
    if path not in weights:
        return None
    arr = weights[path]
    if tag == "dwconv":
        arr = np.transpose(arr, (0, 2, 1))  # [k, C, 1] → [k, 1, C]
    elif tag is not None and tag.startswith("lstm_"):
        u = arr.shape[-1] // 4
        o = _GATE_OFFSET[tag[len("lstm_"):]] * u
        arr = arr[..., o: o + u]
    return np.asarray(arr, np.float32)


def load_transducer_h5(h5_path: str, model: torch.nn.Module, strict: bool = True) -> dict[str, torch.Tensor]:
    """The reference Conformer-Transducer weights of ``h5_path`` as a
    ``state_dict`` for ``model`` (``model.load_state_dict(sd)``): every
    entry the h5 holds converted, the others as ``model`` has them, which
    under ``strict`` raises ``ValueError`` naming them instead; a converted
    entry of another shape than the model's raises too."""
    weights = read_h5_arrays(h5_path)
    if not any("multi_head_relative_attention" in k for k in weights):  # plain-MHA checkpoints name their layers so
        weights = {k.replace("multi_head_relative_attention", "multi_head_attention"): v for k, v in weights.items()}

    tree: dict = {"params": {}, "batch_stats": {}}
    converted, missing = [], []
    for key, flax_keys in _flax_keys(model).items():
        values = [_h5_value(k, weights) for k in flax_keys]
        if any(v is None for v in values):
            missing.append(key)
            continue
        converted.append(key)
        for flax_key, value in zip(flax_keys, values):
            *scopes, leaf = flax_key.split("/")
            node = tree
            for s in scopes:
                node = node.setdefault(s, {})
            node[leaf] = value
    if strict and missing:
        raise ValueError(f"unmapped/missing weights for {len(missing)} entries, e.g. {missing[:5]}")

    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    loaded = bridge.state_dict_from_flax(tree)
    for key in converted:
        if tuple(loaded[key].shape) != tuple(state[key].shape):
            raise ValueError(f"shape mismatch for {key}: h5 {tuple(loaded[key].shape)} vs model {tuple(state[key].shape)}")
        state[key] = loaded[key].to(state[key].dtype)
    return state
