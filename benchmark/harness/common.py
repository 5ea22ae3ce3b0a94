"""What every run shares: the checkout's paths, the cache directories kept
inside it, the data files found by name, the device record, the check for
modules of the JAX package, and the result line."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH = ROOT / "benchmark"
CACHE = ROOT / ".bench_cache"  # every cache a run writes, at a fixed path inside the checkout
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "tensorflowasr_tpu"})

# Published peaks of the card (NVIDIA data sheet, SXM, dense): bf16 tensor-core operations and HBM bytes a second.
PEAKS = {"NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes": 3.35e12}}


def set_environment() -> None:
    """Keep the build and kernel caches of the program inside the checkout, and keep libraries from loading JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str) -> dict:
    for w in manifest()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def reports(metric: dict, workload: dict, e2e_of_cell: set) -> bool:
    """Whether a metric of BENCHMARK.json is reported in ``workload``: where it lists cells, in those; else in every cell that
    reports the end-to-end metric it moves (an end-to-end metric without a list: in every cell)."""
    if "workloads" in metric:
        return workload["name"] in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def forbidden_loaded() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit_w():
    """The card's power limit from ``nvidia-smi`` (None where it cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"], capture_output=True, text=True,
                             timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_record(torch, count: int) -> dict:
    if torch.cuda.is_available():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated()), "power_limit_w": power_limit_w()}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0, "power_limit_w": None}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r} in the benchmark's table")
    return PEAKS[kind]


def emit(result: dict, checks: dict) -> None:
    """The compared numbers beside their limits as the last lines on standard
    error, then the result as the last line of standard output (checks last)."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
