"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them
with ``ctypes``.

Each source under ``tensorflowasr_tpu_torch/csrc/`` compiles to an object
in its own ``nvcc -c`` process, all started together, and one more ``nvcc``
links the objects into one shared library with a plain C interface (no
PyTorch headers, so the build takes seconds, not minutes). The library
lands in ``tensorflowasr_tpu_torch/_build/`` under a name keyed on the
sources' and flags' hash, so an edited source never loads a stale build.
Every C entry point returns ``cudaGetLastError()``; :func:`check` raises
when it is not 0.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("frontend.cu", "rel_attention.cu", "rel_attention_mma.cu", "ff.cu", "ff_mma.cu", "conv_module.cu", "conv_mma.cu", "row_reduce.cu", "rnnt_dp.cu",
           "joint_loss.cu", "joint_loss_mma.cu", "rnnt_rows.cu", "lstm.cu", "ctc.cu", "attention.cu", "attention_mma.cu", "decode.cu")
HEADERS = ("common.cuh", "mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_DROP = [_U, _U, _F, _I]  # seed, threshold, keep scale, on
_SIGNATURES = {
    "tfasr_log_mel": ([_P] * 5 + [_I] * 7 + [_F, _P], ctypes.c_int),
    "tfasr_rel_attention": ([_P] * 9 + [_I] * 11 + _DROP + [_I, _P], ctypes.c_int),
    "tfasr_rel_attention_bwd": ([_P] * 17 + [_I] * 11 + _DROP + [_I, _P], ctypes.c_int),
    "tfasr_rel_mma_smem": ([_I] * 2, ctypes.c_longlong),
    "tfasr_rel_mma_occupancy": ([_I] * 2, ctypes.c_int),
    "tfasr_rel_mma_window_base": ([_I] * 4, ctypes.c_int),
    "tfasr_rel_mma_band_column": ([_I] * 2, ctypes.c_int),
    "tfasr_rel_mma_dpos_rows": ([_I] * 4 + [_P], ctypes.c_int),
    "tfasr_fused_ff": ([_P] * 8 + [_I] * 4 + [_F, _F] + _DROP + [_I, _P], ctypes.c_int),
    "tfasr_fused_ff_bwd": ([_P] * 15 + [_I] * 3 + [_F, _F] + _DROP + [_I, _P], ctypes.c_int),
    "tfasr_fused_ff_bwd_scratch": ([_I] * 4, ctypes.c_longlong),
    "tfasr_ff_mma_smem": ([_I] * 2, ctypes.c_longlong),
    "tfasr_ff_mma_occupancy": ([_I] * 2, ctypes.c_int),
    "tfasr_ff_mma_splits": ([_I] * 3 + [_P], ctypes.c_int),
    "tfasr_conv_front": ([_P] * 8 + [_I, _I, _F, _I, _P], ctypes.c_int),
    "tfasr_conv_front_bwd": ([_P] * 16 + [_I, _I, _F, _I, _P], ctypes.c_int),
    "tfasr_conv_back": ([_P] * 9 + [_I, _I, _F, _F] + _DROP + [_I, _P], ctypes.c_int),
    "tfasr_conv_back_bwd": ([_P] * 15 + [_I, _I, _F, _F] + _DROP + [_I, _P], ctypes.c_int),
    "tfasr_conv_bwd_scratch": ([_I] * 2, ctypes.c_longlong),
    "tfasr_conv_front_mma_scratch": ([_I] * 2, ctypes.c_longlong),
    "tfasr_conv_mma_smem": ([_I] * 2, ctypes.c_longlong),
    "tfasr_conv_mma_occupancy": ([_I] * 2, ctypes.c_int),
    "tfasr_rnnt_dp": ([_P] * 8 + [_I] * 3 + [_P], ctypes.c_int),
    "tfasr_joint_fwd": ([_P] * 8 + [_I] * 6 + [_P], ctypes.c_int),
    "tfasr_joint_bwd": ([_P] * 13 + [_I] * 6 + [_P], ctypes.c_int),
    "tfasr_joint_bwd_scratch": ([_I] * 6, ctypes.c_longlong),
    "tfasr_joint_mma_smem": ([_I] * 2, ctypes.c_longlong),
    "tfasr_joint_mma_occupancy": ([_I] * 2, ctypes.c_int),
    "tfasr_joint_mma_layout": ([_I] * 5 + [_P], ctypes.c_int),
    "tfasr_joint_mma_fwd_resident": ([_I] * 2, ctypes.c_int),
    "tfasr_rnnt_logprobs": ([_P] * 5 + [_I] * 6 + [_P], ctypes.c_int),
    "tfasr_rnnt_dlogits": ([_P] * 7 + [_I] * 6 + [_P], ctypes.c_int),
    "tfasr_lstm_fwd": ([_P] * 8 + [_I] * 6 + [_P], ctypes.c_int),
    "tfasr_lstm_bwd": ([_P] * 10 + [_I] * 5 + [_P], ctypes.c_int),
    "tfasr_ctc": ([_P] * 6 + [_I] * 3 + [_P], ctypes.c_int),
    "tfasr_attention": ([_P] * 6 + [_I] * 5 + _DROP + [_I, _P], ctypes.c_int),
    "tfasr_attention_bwd": ([_P] * 14 + [_I] * 5 + _DROP + [_I, _P], ctypes.c_int),
    # enc_p, lens, tok0, embed; n_layers; six host arrays of per-layer pointers; wp, bp, wv, bv, st0; four outputs;
    # B, T, E, H, P, J, V, K, max_tokens, step_max, blank; eps; cluster size, host array of resident rows; dtype, stream
    "tfasr_greedy_decode": ([_P] * 4 + [_I] + [_P] * 6 + [_P] * 5 + [_P] * 4 + [_I] * 11 + [_F] + [_I, _P] + [_I, _P], ctypes.c_int),
    "tfasr_decode_smem_bytes": ([_I] * 6 + [_P, _I], ctypes.c_longlong),
    "tfasr_decode_clusters": ([_I, ctypes.c_longlong, _I], ctypes.c_int),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the first build() in this process
build_log: str = ""  # nvcc/ptxas output of that build (registers, shared memory, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's CUDA kernels build on a machine with the CUDA toolkit")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libtfasr_kernels_{h.hexdigest()[:16]}.so"


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), f"{path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(f"== {s}\n{log}" for s, log in zip(SOURCES, logs))
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = path.with_name(f"{tag}.tmp.so")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True, check=False)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed with exit code {proc.returncode}:\n{build_log}")
        os.replace(tmp, path)
        for o in objs:
            o.unlink()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, *, device: torch.device, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous tensor of this device, dtype and shape."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def compute_dtype(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {t.dtype} not supported by the kernel (float32 or bfloat16)")
    return DTYPE_CODE[t.dtype]
