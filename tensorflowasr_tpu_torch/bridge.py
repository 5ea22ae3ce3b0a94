"""JAX/flax variables → the port's ``state_dict``.

Takes ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (``jax.tree_util.tree_map(np.asarray, variables)`` on the JAX side;
this module imports no JAX) and returns a ``state_dict`` for the port's
module of the same name tree (``model.load_state_dict(sd)``). Rules:

- path segments join with "."; the single unnamed child scopes flax adds
  (``Conv_0`` inside Conv1D/Conv2D wrappers, ``BatchNorm_0``/``LayerNorm_0`` inside Norm)
  are dropped, so the fused-path mirror trees and the XLA trees map alike;
- Dense ``kernel [in, out]`` → ``weight [out, in]``;
- DenseGeneral ``query/key/value/encoding`` ``[D, N, H]`` → ``[N·H, D]``
  (bias ``[N, H]`` → ``[N·H]``), ``output`` ``[N, H, D]`` → ``[D, N·H]``;
- Conv2D HWIO → OIHW; Conv1D ``[K, Cin, Cout]`` → ``[Cout, Cin, K]``
  (pointwise ``[1, Cin, Cout]`` → ``[Cout, Cin, 1]``, depthwise
  ``[K, 1, D]`` → ``[D, 1, K]``);
- LayerNorm/BatchNorm ``scale`` → ``weight``; batch_stats ``mean``/``var``
  → ``running_mean``/``running_var``;
- ``nn.Embed`` ``embedding`` → ``weight``;
- ``nn.OptimizedLSTMCell`` ``{ii,if,ig,io}`` (no bias) and
  ``{hi,hf,hg,ho}`` (with bias) → ``weight_ih [4U, E]``,
  ``weight_hh [4U, U]``, ``bias [4U]``, gate order i, f, g, o.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_DROP = {"Conv_0", "BatchNorm_0", "LayerNorm_0"}
_HEAD_IN = {"query", "key", "value", "encoding"}
_GATES = ("i", "f", "g", "o")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _lstm_cell(cell: Mapping) -> dict[str, np.ndarray]:
    w_ih = np.concatenate([np.asarray(cell["i" + g]["kernel"]).T for g in _GATES], axis=0)
    w_hh = np.concatenate([np.asarray(cell["h" + g]["kernel"]).T for g in _GATES], axis=0)
    bias = np.concatenate([np.asarray(cell["h" + g]["bias"]) for g in _GATES], axis=0)
    return {"weight_ih": w_ih, "weight_hh": w_hh, "bias": bias}


def _convert_param(path: tuple, value: np.ndarray) -> tuple[tuple, np.ndarray]:
    parent, leaf = path[-2] if len(path) > 1 else "", path[-1]
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif parent in _HEAD_IN and value.ndim == 3:
            value = value.reshape(value.shape[0], -1).T
        elif parent == "output" and value.ndim == 3:
            value = value.reshape(-1, value.shape[-1]).T
        elif value.ndim == 3:
            value = value.transpose(2, 1, 0)
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        leaf = "weight"
    elif leaf == "bias" and parent in _HEAD_IN and value.ndim == 2:
        value = value.reshape(-1)
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return path[:-1] + (leaf,), value


def state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Convert JAX variables (nested numpy dicts) to the port's state_dict."""
    params = variables["params"]
    out: dict[str, torch.Tensor] = {}

    def emit(path: tuple, value: np.ndarray) -> None:
        key = ".".join(p for p in path if p not in _DROP)
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    cells = {p[: p.index("cell") + 1] for p in _flatten(params) if "cell" in p}
    for cell_path in cells:
        node = params
        for k in cell_path:
            node = node[k]
        for name, value in _lstm_cell(node).items():
            emit(cell_path + (name,), value)
    for path, value in _flatten(params).items():
        if "cell" in path:
            continue
        emit(*_convert_param(path, value))
    for path, value in _flatten(variables.get("batch_stats", {})).items():
        emit(path[:-1] + ({"mean": "running_mean", "var": "running_var"}[path[-1]],), value)
    return out
