"""The native FLAC decoder (``flac_decoder.cc``), built with ``g++`` at first
use and bound with ``ctypes`` (counterpart of ``tensorflowasr_tpu/native/__init__.py``).

The library lands in ``tensorflowasr_tpu_torch/_build/`` under a name keyed
on the source's hash, written to a temporary file and renamed into place
(``ops/cuda/_build.py``'s :func:`hashed_library` and :func:`write_library`,
which need no CUDA), so processes that build at once never load a
half-written library and an edited source never loads a stale one. A failed build or load raises: the
data loader has no silent fallback to the pure-Python decoder, which is
about 100× slower (``data/audio.py:read_flac_python`` stays as the plain
version for the tests). The calls release the interpreter lock, so decode
threads run in parallel. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from tensorflowasr_tpu_torch.ops.cuda import _build

SOURCE = Path(__file__).resolve().parent / "flac_decoder.cc"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    return _build.hashed_library("tfasr_flac", (SOURCE,), CXX_FLAGS)


def load(path: Path, source: Path, what: str) -> ctypes.CDLL:
    """The library at ``path``, built first from ``source`` with ``g++`` if
    it is absent; a failed build raises (also for ``native/zstd.py``)."""
    if not path.exists():
        proc = _build.write_library(path, lambda tmp: ["g++", *CXX_FLAGS, "-o", tmp, str(source)], timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native {what} decoder failed ({proc.returncode}):\n{proc.stderr}")
    return ctypes.CDLL(str(path))


def lib() -> ctypes.CDLL:
    """The loaded library, built first if there is none for this source."""
    global _lib
    with _lock:
        if _lib is None:
            lib_ = load(library_path(), SOURCE, "FLAC")
            lib_.tfasr_flac_info.restype = ctypes.c_int
            lib_.tfasr_flac_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + [ctypes.POINTER(ctypes.c_int32)] * 3 + [ctypes.POINTER(ctypes.c_int64)]
            lib_.tfasr_flac_decode.restype = ctypes.c_int64
            lib_.tfasr_flac_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
            _lib = lib_
        return _lib


def read_flac_native(path: str) -> tuple[np.ndarray, int]:
    """Decode a FLAC file: (float32 samples [N] mono or [N, C], rate). Raises on a stream it cannot decode."""
    lib_ = lib()
    with open(path, "rb") as f:
        data = f.read()
    rate, channels, bps, total = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    if lib_.tfasr_flac_info(data, len(data), ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(bps), ctypes.byref(total)) != 0:
        raise ValueError(f"not a FLAC stream the native decoder reads: {path}")
    n, ch = int(total.value), int(channels.value)
    out = np.empty(n * ch, np.int32)
    written = lib_.tfasr_flac_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
    if written < 0:
        raise ValueError(f"native FLAC decode failed ({written}) for {path}")
    pcm = out[: written * ch].reshape(-1, ch)
    x = (pcm.astype(np.float32) / float(1 << (int(bps.value) - 1))).astype(np.float32)
    return (x[:, 0] if ch == 1 else x), int(rate.value)
