"""JAX/flax variables → the port's ``state_dict``, and BatchNorm running
statistics back.

:func:`state_dict_from_flax` takes ``{"params": ..., "batch_stats": ...}``
as nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
variables)`` on the JAX side; this module imports no JAX) and returns a
``state_dict`` for the port's module of the same name tree
(``model.load_state_dict(sd)``). :func:`batch_stats_to_flax` carries the
running statistics (which training updates) back into a flax
``batch_stats`` tree. Rules:

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
  ``weight_hh [4U, U]``, ``bias [4U]``, gate order i, f, g, o; the cells
  are the scopes named ``cell`` and, in a bidirectional layer, ``cell_bwd``;
- ``nn.GRUCell`` ``{ir,iz,in}`` (with bias) and ``{hr,hz}`` (no bias),
  ``hn`` (with bias) → ``weight_ih [3U, E]``, ``bias_ih [3U]``,
  ``weight_hh [3U, U]``, ``bias_hn [U]``, gate order r, z, n;
- the simple RNN cell's Dense ``i`` and ``h`` → ``weight_ih``, ``bias_ih``,
  ``weight_hh``, ``bias_hh``;
- every other leaf keeps its name: a trainable residual's ``factor`` (a
  scalar), ``SequenceBatchNorm``'s ``gamma`` and ``beta``.

These rules cover every model family and every Conformer option with no
per-model code (``ln_pre``, a LayerNorm ``dw_norm``, the grouped
``dw_conv`` kernel [K, Cin/D, D] → [D, Cin/D, K], the Conv1d and VGG
subsamplings' ``conv_i`` / ``conv_b_c``, ``DepthwiseConv2D``'s [kt, kf,
1, C·m] → [C·m, 1, kt, kf]): the RNN-T
blocks (``block_i.rnn.cell``, ``.ln``, ``.projection``), ContextNet (each
``SeparableConv1D``'s ``depthwise`` [K, 1, C] and ``pointwise`` [1, Cin,
Cout] kernels, every BatchNorm's params and ``batch_stats``, the SE's
``fc1``/``fc2``) and the Transformer-T (the Transformer's mapping).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_DROP = {"Conv_0", "BatchNorm_0", "LayerNorm_0"}
_HEAD_IN = {"query", "key", "value", "encoding"}
_GATES = ("i", "f", "g", "o")
_STATS = {"mean": "running_mean", "var": "running_var"}
_CELLS = ("cell", "cell_bwd")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _kernels(cell: Mapping, names) -> np.ndarray:
    return np.concatenate([np.asarray(cell[n]["kernel"]).T for n in names], axis=0)


def _biases(cell: Mapping, names) -> np.ndarray:
    return np.concatenate([np.asarray(cell[n]["bias"]) for n in names], axis=0)


def _lstm_cell(cell: Mapping) -> dict[str, np.ndarray]:
    gates = lambda side: [side + g for g in _GATES]
    return {"weight_ih": _kernels(cell, gates("i")), "weight_hh": _kernels(cell, gates("h")), "bias": _biases(cell, gates("h"))}


def _cell(cell: Mapping) -> dict[str, np.ndarray]:
    """An LSTM, GRU or simple-RNN cell's parameters, told apart by their names."""
    if "ir" in cell:
        gru = ("ir", "iz", "in")
        return {"weight_ih": _kernels(cell, gru), "bias_ih": _biases(cell, gru), "weight_hh": _kernels(cell, ("hr", "hz", "hn")),
                "bias_hn": _biases(cell, ("hn",))}
    if "i" in cell:
        return {"weight_ih": _kernels(cell, ("i",)), "bias_ih": _biases(cell, ("i",)), "weight_hh": _kernels(cell, ("h",)), "bias_hh": _biases(cell, ("h",))}
    return _lstm_cell(cell)


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

    in_cell = lambda path: any(c in path for c in _CELLS)
    cells = {p[: next(i for i, k in enumerate(p) if k in _CELLS) + 1] for p in _flatten(params) if in_cell(p)}
    for cell_path in cells:
        node = params
        for k in cell_path:
            node = node[k]
        for name, value in _cell(node).items():
            emit(cell_path + (name,), value)
    for path, value in _flatten(params).items():
        if in_cell(path):
            continue
        emit(*_convert_param(path, value))
    for path, value in _flatten(variables.get("batch_stats", {})).items():
        emit(path[:-1] + (_STATS[path[-1]],), value)
    return out


def batch_stats_to_flax(state_dict: Mapping[str, torch.Tensor], like: Mapping) -> dict:
    """The port's running statistics as a flax ``batch_stats`` tree with
    the paths of ``like`` (an existing ``batch_stats`` tree), numpy f32."""

    def walk(node: Mapping, path: tuple) -> dict:
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                out[k] = walk(v, path + (k,))
            else:
                key = ".".join(p for p in path + (_STATS[k],) if p not in _DROP)
                out[k] = state_dict[key].detach().cpu().numpy().astype(np.float32)
        return out

    return walk(like, ())
