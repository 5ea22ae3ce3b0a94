"""Reads the JAX package's orbax checkpoints without orbax or tensorstore.

:func:`read_checkpoint` returns the tree that the JAX writer saved, as
nested dicts and lists of numpy arrays, equal leaf by leaf to
``orbax.checkpoint.StandardCheckpointer().restore(path)`` (a ``bfloat16``
leaf comes back as a ``torch.bfloat16`` tensor, since numpy has no such
dtype; an empty node as orbax restores it: ``None``, ``{}``, ``[]`` or
``()``; a Python scalar as a Python scalar). It reads these layouts:

- an item directory, which holds ``_METADATA`` (``scripts/save.py`` and
  ``utils convert_checkpoint`` write one);
- a step directory of a ``CheckpointManager`` (its ``default/`` item);
- a ``CheckpointManager`` root (numbered step directories; the newest is read).

The item is an OCDBT key-value store (``manifest.ocdbt``, B+tree nodes and
values under ``d/`` and ``ocdbt.process_*/d/``) or, when it was saved with
``use_ocdbt=False``, one directory per leaf. Each leaf is a zarr v2 array
(``<name>/.zarray`` and chunks ``<name>/0.0``...), its chunks zstd-coded or
raw. Every zstd stream goes through the native decoder
(``native/zstd.py``). Each OCDBT node's CRC32C is checked. A zarr v3
array, a dictionary-coded zstd frame or a corrupt file raises
:class:`OrbaxFormatError` (a ``ValueError``) that names it.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import struct
from collections.abc import Callable

import numpy as np
import torch

from tensorflowasr_tpu_torch.native.zstd import zstd_decode


class OrbaxFormatError(ValueError):
    pass


MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
METADATA = "_METADATA"


# ----------------------------------------------------------------------------
# CRC32C (Castagnoli), as tensorstore appends it to every OCDBT node.

def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ----------------------------------------------------------------------------
# OCDBT

class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.i, self.what = buf, 0, what

    def byte(self) -> int:
        if self.i >= len(self.buf):
            raise OrbaxFormatError(f"truncated {self.what}")
        self.i += 1
        return self.buf[self.i - 1]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return value
            if shift > 63:
                raise OrbaxFormatError(f"bad varint in {self.what}")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.i + n > len(self.buf):
            raise OrbaxFormatError(f"truncated {self.what}")
        self.i += n
        return self.buf[self.i - n : self.i]


def _envelope(data: bytes, magic: int, what: str) -> _Reader:
    """The body of an OCDBT manifest or node: magic, length, version and compression checked, CRC32C verified."""
    if len(data) < 18 or struct.unpack_from(">I", data, 0)[0] != magic:
        raise OrbaxFormatError(f"{what}: not an OCDBT {'manifest' if magic == MANIFEST_MAGIC else 'B+tree node'}")
    if struct.unpack_from("<Q", data, 4)[0] != len(data):
        raise OrbaxFormatError(f"{what}: length field does not match the {len(data)} bytes read")
    if struct.unpack_from("<I", data, len(data) - 4)[0] != crc32c(data[:-4]):
        raise OrbaxFormatError(f"{what}: CRC32C checksum mismatch")
    head = _Reader(data[:-4], what)
    head.i = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: OCDBT format version {version} is not read here")
    body = data[head.i : -4]
    if compression == 1:
        try:
            body = zstd_decode(body)
        except ValueError as e:
            raise OrbaxFormatError(f"{what}: {e}") from None
    elif compression != 0:
        raise OrbaxFormatError(f"{what}: unknown compression {compression}")
    return _Reader(body, what)


def _data_file_table(r: _Reader, base: str) -> list[tuple[str, str]]:
    """A node's table of data files, each as (its base path, its path), relative
    to the store's root: the entries of a node read from a file are relative
    to that file's base path."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    paths, previous = [], b""
    for i in range(n):
        if prefix[i] > len(previous):
            raise OrbaxFormatError(f"bad data file table in {r.what}")
        full = previous[: prefix[i]] + r.raw(suffix[i])
        if base_len[i] > len(full):
            raise OrbaxFormatError(f"bad data file table in {r.what}")
        paths.append((base + full[: base_len[i]].decode(), base + full.decode()))
        previous = full
    return paths


def _file_id(r: _Reader, table: list[tuple[str, str]]) -> tuple[str, str]:
    i = r.varint()
    if i >= len(table):
        raise OrbaxFormatError(f"data file index {i} out of range in {r.what}")
    return table[i]


class OcdbtStore:
    """The newest version of an OCDBT store: every key with its value or a reference to it."""

    def __init__(self, root: str):
        self.root = root
        self._files: dict[str, bytes] = {}
        r = _envelope(self._read_file("manifest.ocdbt"), MANIFEST_MAGIC, os.path.join(root, "manifest.ocdbt"))
        r.raw(16)  # uuid
        kind = r.varint()
        r.varint(), r.varint()  # max inline value bytes, max decoded node bytes
        r.byte()  # version tree arity log2
        if r.varint() == 1:
            r.raw(4)  # zstd level
        if kind != 0:
            raise OrbaxFormatError(f"{root}: an OCDBT store with numbered manifests is not read here")
        table = _data_file_table(r, "")
        n = r.varint()
        if n == 0:
            self.root_node = None
            return
        generation, height = r.varints(n), [r.byte() for _ in range(n)]
        files = [_file_id(r, table) for _ in range(n)]
        offset, length = r.varints(n), r.varints(n)
        newest = max(range(n), key=lambda i: generation[i])
        self.root_node = (files[newest], offset[newest], length[newest], height[newest])

    def _read_file(self, rel: str) -> bytes:
        if rel not in self._files:
            path = os.path.join(self.root, rel)
            if not os.path.isfile(path):
                raise OrbaxFormatError(f"missing OCDBT file {path}")
            with open(path, "rb") as f:
                self._files[rel] = f.read()
        return self._files[rel]

    def _range(self, rel: str, offset: int, length: int) -> bytes:
        data = self._read_file(rel)
        if offset + length > len(data):
            raise OrbaxFormatError(f"reference past the end of {os.path.join(self.root, rel)}")
        return data[offset : offset + length]

    def items(self) -> dict[str, bytes]:
        """Every key of the newest version and its value."""
        out: dict[str, bytes] = {}
        if self.root_node is not None:
            file, offset, length, height = self.root_node
            self._walk(file, offset, length, b"", height, out)
        return out

    def _walk(self, file: tuple[str, str], offset: int, length: int, prefix: bytes, height: int, out: dict) -> None:
        base, rel = file
        what = f"{os.path.join(self.root, rel)}@{offset}"
        r = _envelope(self._range(rel, offset, length), BTREE_NODE_MAGIC, what)
        if r.byte() != height:
            raise OrbaxFormatError(f"{what}: node height differs from its reference")
        table = _data_file_table(r, base)
        n = r.varint()
        shared = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if height > 0 else None
        keys, previous = [], b""
        for i in range(n):
            if shared[i] > len(previous):
                raise OrbaxFormatError(f"{what}: bad key prefix")
            previous = previous[: shared[i]] + r.raw(suffix[i])
            keys.append(previous)
        if height > 0:
            files = [_file_id(r, table) for _ in range(n)]
            offsets, lengths = r.varints(n), r.varints(n)
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise OrbaxFormatError(f"{what}: bad subtree prefix")
                self._walk(files[i], offsets[i], lengths[i], prefix + keys[i][: common[i]], height - 1, out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k > 1 for k in kinds):
            raise OrbaxFormatError(f"{what}: unknown value kind")
        files = [_file_id(r, table) for _ in indirect]
        offsets = r.varints(len(indirect))
        refs = dict(zip(indirect, zip(files, offsets)))
        for i in range(n):
            key = (prefix + keys[i]).decode()
            if i in refs:
                out[key] = self._range(refs[i][0][1], refs[i][1], lengths[i])
            else:
                out[key] = r.raw(lengths[i])


# ----------------------------------------------------------------------------
# zarr v2

_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<f2": np.float16, "<i4": np.int32, "<i8": np.int64, "<u4": np.uint32, "|b1": np.bool_,
           "bfloat16": np.uint16}  # bf16 read as its raw 16 bits


def _fill(value, dtype: str):
    if value is None:
        return 0
    if isinstance(value, str):
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}.get(value, value)
    if dtype == "bfloat16":
        bits = int(np.float32(value).view(np.uint32))
        return (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    return value


def read_zarr(get: Callable[[str], bytes | None], name: str) -> np.ndarray | torch.Tensor:
    """The zarr v2 array ``name`` from a key-value lookup (``None`` for an absent key)."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        if get(f"{name}/zarr.json") is not None:
            raise OrbaxFormatError(f"{name}: a zarr v3 array (zarr.json), which is not read here")
        raise OrbaxFormatError(f"{name}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr format {meta.get('zarr_format')} is not read here")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: zarr filters {meta['filters']} are not read here")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: zarr order {meta['order']} is not read here")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: zarr compressor {compressor.get('id')} is not read here")
    dtype = meta["dtype"]
    if dtype not in _DTYPES:
        raise OrbaxFormatError(f"{name}: zarr dtype {dtype} is not read here")
    np_dtype = np.dtype(_DTYPES[dtype])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype), np_dtype)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * np_dtype.itemsize
    for idx in itertools.product(*(range(g) for g in grid)):
        data = get(f"{name}/" + (sep.join(map(str, idx)) if idx else "0"))
        if data is None:
            continue
        if compressor is not None:
            try:
                data = zstd_decode(data)
            except ValueError as e:
                raise OrbaxFormatError(f"{name}/{sep.join(map(str, idx))}: {e}") from None
        if len(data) != chunk_bytes:
            raise OrbaxFormatError(f"{name}: chunk {idx} holds {len(data)} bytes, not {chunk_bytes}")
        chunk = np.frombuffer(data, np_dtype).reshape(chunks)
        where = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[where] = chunk[tuple(slice(0, w.stop - w.start) for w in where)]
    if dtype == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# ----------------------------------------------------------------------------
# layouts and the tree

_EMPTY = {"None": lambda: None, "NamedTuple": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}


def item_directory(path: str) -> str:
    """The orbax item directory that ``path`` names (see the module docstring)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise OrbaxFormatError(f"{path}: not a directory")
    if os.path.isfile(os.path.join(path, METADATA)):
        return path
    if os.path.isfile(os.path.join(path, "zarr.json")):
        raise OrbaxFormatError(f"{path}: a zarr v3 store (zarr.json), which is not read here")
    items = [d for d in sorted(os.listdir(path)) if os.path.isfile(os.path.join(path, d, METADATA))]
    if items:
        return os.path.join(path, "default" if "default" in items else items[0])
    steps = [d for d in os.listdir(path) if d.isdigit() and os.path.isdir(os.path.join(path, d))]
    if steps:
        return item_directory(os.path.join(path, max(steps, key=int)))
    raise OrbaxFormatError(f"{path}: not an orbax checkpoint (no {METADATA}, no item directory holding one, no numbered step)")


def is_checkpoint(path: str) -> bool:
    """Whether ``path`` is a directory that :func:`read_checkpoint` reads."""
    try:
        item_directory(path)
    except OrbaxFormatError:
        return False
    return True


def read_checkpoint(path: str) -> dict:
    """The tree saved at ``path`` (see the module docstring)."""
    item = item_directory(path)
    with open(os.path.join(item, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{item}: saved with zarr3 (use_zarr3), which is not read here")
    if meta.get("use_ocdbt", False):
        if not os.path.isfile(os.path.join(item, "manifest.ocdbt")):
            raise OrbaxFormatError(f"{item}: use_ocdbt is set and there is no manifest.ocdbt")
        kv = OcdbtStore(item).items()
        get = kv.get
    else:
        def get(key: str) -> bytes | None:
            p = os.path.join(item, *key.split("/"))
            if not os.path.isfile(p):
                return None
            with open(p, "rb") as f:
                return f.read()
    tree: dict = {}
    kinds: dict[int, int] = {}  # id(node) -> the key type of its children
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value_meta = entry.get("value_metadata", {})
        value_type = value_meta.get("value_type")
        if value_type in _EMPTY:
            value = _EMPTY[value_type]()
        else:
            value = read_zarr(get, ".".join(str(k["key"]) for k in keys))
            if value_type == "scalar":
                value = value.item()
        node = tree
        for depth, k in enumerate(keys):
            kinds.setdefault(id(node), k["key_type"])
            key = int(k["key"]) if k["key_type"] == 1 else k["key"]
            if depth == len(keys) - 1:
                node[key] = value
            else:
                node = node.setdefault(key, {})
    return _containers(tree, kinds)


def _containers(node, kinds: dict):
    """Sequence nodes (key type 1) as lists in index order, the rest as dicts."""
    if not isinstance(node, dict) or id(node) not in kinds:
        return node
    children = {k: _containers(v, kinds) for k, v in node.items()}
    if kinds[id(node)] == 1:
        return [children[i] for i in sorted(children)]
    return children


# ----------------------------------------------------------------------------
# the port's weights

def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def flax_variables(tree: dict) -> dict:
    """The flax variables of a read tree: its ``params`` and ``batch_stats``
    (a ``save.py`` or ``convert_checkpoint`` artifact, a ``TrainState``), or
    the whole tree as ``params`` when it has no such scope; bf16 leaves as f32."""
    if "params" not in tree:
        return {"params": _as_numpy(tree)}
    return {"params": _as_numpy(tree["params"]), "batch_stats": _as_numpy(tree.get("batch_stats") or {})}


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` of the JAX model saved at ``path`` (``bridge.state_dict_from_flax`` of its variables)."""
    from tensorflowasr_tpu_torch import bridge

    return bridge.state_dict_from_flax(flax_variables(read_checkpoint(path)))
