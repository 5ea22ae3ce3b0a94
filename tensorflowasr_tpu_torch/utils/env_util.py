"""Runtime set-up for the command line (counterpart of
``tensorflowasr_tpu/utils/env_util.py``): logging, seeds, the numerics
check, device discovery, the device mesh and the compute dtype.

One card a process: a mesh is a ``DeviceMesh`` over the ranks of the
``torch.distributed`` group (``parallel/sharding.py``), which ``torchrun``
or ``parallel.init_process_group`` forms. JAX's ``cpu_offline_backend(n)``
(n virtual CPU devices in one process) has as its counterpart
``parallel.spawn(fn, n, device="cpu")``: n gloo ranks, one process each."""

from __future__ import annotations

import logging
import os
import random
from typing import Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger("tensorflowasr_tpu_torch")


def setup_logging(level: int = logging.INFO) -> logging.Logger:
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s", datefmt="%Y-%m-%dT%H:%M:%S"))
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger


def setup_seed(seed: int = 42) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; returns a CPU
    ``torch.Generator`` seeded with ``seed`` (the JAX root key's counterpart)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def setup_check_numerics(env_var: str = "TFASR_CHECK_NUMERICS") -> bool:
    """When ``TFASR_CHECK_NUMERICS`` is truthy, turn on autograd's anomaly
    detection (a backward that makes NaN names the forward operation at
    fault) and return True: the caller then checks each step's metrics
    (``training.callbacks.CheckNumerics``), as JAX's ``jax_debug_nans`` and
    ``jax_debug_infs`` trap inside the step."""
    if os.environ.get(env_var, "").lower() in ("1", "true", "yes"):
        torch.autograd.set_detect_anomaly(True)
        logger.info("check-numerics enabled (autograd anomaly detection + a finite-metrics check after each step)")
        return True
    return False


def has_devices(kind: str = "gpu") -> bool:
    """Whether a device of ``kind`` ("gpu" or "cuda": a CUDA card; "cpu") is present."""
    kind = kind.lower()
    if kind in ("gpu", "cuda"):
        return torch.cuda.is_available() and torch.cuda.device_count() > 0
    return kind == "cpu"


def num_devices() -> int:
    """CUDA cards visible to this process."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def setup_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None, device=None):
    """A ``DeviceMesh`` of ``device``'s type (None: CUDA) over every rank of
    the process group (JAX ``setup_mesh``): by default 1-D over all ranks,
    extra axes of size 1; ``shape`` lays the ranks out row-major (the last
    axis innermost, e.g. ("data", "model") for ``parallel/tp.py``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_process_group (or run under torchrun) first")
    world = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (world,) + (1,) * (len(axis_names) - 1)
    return DeviceMesh(torch.device(device or "cuda").type, torch.arange(world).reshape(shape), mesh_dim_names=tuple(axis_names))


def setup_mxp(policy: str = "strict", device=None) -> torch.dtype:
    """The compute dtype (parameters stay f32): "strict" (and "mxp",
    "mixed_bfloat16") bf16; "auto" bf16 on the card and f32 on the CPU
    (``device``, or a card when there is one); "none" f32."""
    policy = (policy or "none").lower()
    if policy in ("strict", "mxp", "mixed_bfloat16"):
        return torch.bfloat16
    if policy in ("auto", "strict_auto"):
        on_card = torch.device(device).type == "cuda" if device is not None else has_devices("gpu")
        return torch.bfloat16 if on_card else torch.float32
    if policy == "none":
        return torch.float32
    raise ValueError(f"unknown mixed-precision policy {policy!r}: strict, auto or none")
