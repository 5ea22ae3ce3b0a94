"""What the per-layer metrics read from a traced run's record, shared by the
readers under ``benchmark/metrics/`` (one file a metric, found by its name).
Each returns None where the record is not of ``kind`` or lacks what it
reads: the harness then leaves the metric out of the line."""

from __future__ import annotations

import math


def mfu(record: dict, kind: str):
    """Useful operations of the window's steps or requests over the window's seconds × the card's bf16 peak, in %."""
    if record.get("kind") != kind:
        return None
    return 100.0 * record["flops"] / (record["window_s"] * record["peaks"]["flops"])


def roofline(record: dict, kind: str):
    """The profiled sub-window's least time (each step's or request's larger of its useful operations at the bf16 peak and its
    irreducible bytes at the HBM rate) over the device's busy time (the union of its operation intervals), in %."""
    if record.get("kind") != kind or "sub" not in record or record["sub"]["busy_s"] <= 0:
        return None
    return 100.0 * record["sub"]["least_s"] / record["sub"]["busy_s"]


def idle_share(record: dict, kind: str):
    """The share of the profiled sub-window's wall in which no operation ran on the device, in %."""
    if record.get("kind") != kind or "sub" not in record:
        return None
    return 100.0 * (1.0 - record["sub"]["busy_s"] / record["sub"]["wall_s"])


def device_ops(record: dict, kind: str):
    """Device operations (kernels, copies and sets) in the profiled sub-window, per step or request."""
    if record.get("kind") != kind or "sub" not in record:
        return None
    return record["sub"]["ops"] / record["sub"]["n"]


def phase_ms(record: dict, phase: str):
    """Mean ms of a training phase over the window's steps (CUDA events on the trainer's marks)."""
    if record.get("kind") != "train":
        return None
    v = record.get("phase_ms", {}).get(phase)
    return v if v is not None and math.isfinite(v) else None
