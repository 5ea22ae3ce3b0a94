"""The span sub-window's reduction (``harness/spans.py``) on synthetic
traces, and each kernel call's least time (``harness/kernel_work.py``)
against the Bound column of PERF.md's kernel table at the shapes it was
measured at."""

from __future__ import annotations

import math
import types

import pytest
import torch

from benchmark.harness import kernel_work, spans


def ms(name, shapes, dtypes):
    return 1e3 * kernel_work.least_s(name, shapes, dtypes)


BF16 = ["bfloat16"] * 5


@pytest.mark.parametrize("name, shapes, want", [
    ("kernel.ff.fwd", [(6400, 512), (512, 2048)], 0.0271),  # Conformer-L (N 6400, D 512, F 2048): operations
    ("kernel.ff.bwd", [(6400, 512), (512, 2048), (6400, 512)], 0.0679),
    ("kernel.conv_front.fwd", [(6400, 512), (512, 512)], 0.0068),
    ("kernel.conv_front.bwd", [(6400, 512), (512, 512), (6400, 512)], 0.0204),
    ("kernel.conv_front.bwd", [(16, 400, 512), (512, 512), (16, 400, 512)], 0.0204),  # [B, T, D] as the layers call it
    ("kernel.conv_back.fwd", [(16, 400, 144), (16, 400, 144), (144, 144)], 0.0017),
    ("kernel.ff.bwd", [(16, 400, 512), (512, 2048), (16, 400, 512)], 0.0679),
    ("kernel.joint_loss.fwd", [(16, 400, 640), (16, 129, 640), (1024, 640)], 1.0978),  # J 640, V 1024: operations
    ("kernel.joint_loss.bwd", [(16, 400, 320), (16, 129, 320), (256, 320)], 0.4119),  # the flagship's J 320, V 256 over every cell
    ("kernel.ff.fwd", [(6400, 144), (144, 576)], 0.0021),  # the flagship's D 144, F 576
    ("kernel.ff.bwd", [(6400, 144), (144, 576), (6400, 144)], 0.0054),
    ("kernel.conv_front.fwd", [(6400, 144), (144, 144)], 0.0011),  # bytes
    ("kernel.conv_back.fwd", [(6400, 144), (6400, 144), (144, 144)], 0.0017),
    ("kernel.rel_attention.fwd", [(64, 400, 36), (64, 400, 36), (64, 400, 36), (64, 400, 36), (64, 799, 36)], 0.0039),
    ("kernel.rel_attention.bwd", [(64, 400, 36), (64, 400, 36), (64, 400, 36), (64, 400, 36), (64, 799, 36)], 0.0077),
])
def test_least_time_matches_the_kernel_tables_bound(name, shapes, want):
    assert ms(name, shapes, BF16) == pytest.approx(want, abs=6e-5)


def test_f32_takes_the_f32_peak_and_uncounted_kernels_give_none():
    bf16 = ms("kernel.ff.fwd", [(6400, 512), (512, 2048)], BF16)
    f32 = ms("kernel.ff.fwd", [(6400, 512), (512, 2048)], ["float32"] * 2)
    assert f32 / bf16 == pytest.approx(989 / 67, rel=1e-9)
    for name in ("kernel.rnnt_dp", "kernel.ctc", "kernel.decode", "kernel.unknown.fwd"):
        assert kernel_work.least_s(name, [(4, 8, 9)], ["float32"]) is None
    frontend = ms("kernel.frontend", [(16, 256000), (16, 1600, 80)], ["float32"] * 2)  # the flagship's train frontend: bytes
    assert frontend == pytest.approx(0.0073, abs=6e-5)


def _rec(name, start, shapes, dtypes=None):
    return types.SimpleNamespace(name=name, start_ns=start, shapes=shapes, dtypes=dtypes or ["bfloat16"] * len(shapes))


def synthetic():
    """Two steps on thread 1 (the main thread) with a kernel span of the backward on thread 2 (autograd's), device
    operations launched by runtime calls (one linked only through its host operation, one lost), and idle gaps."""
    sp = []
    for k, base in enumerate((0.0, 1000.0)):
        sp += [("train.step", 1, base, base + 900), ("train.forward", 1, base + 10, base + 300), ("kernel.ff.fwd", 1, base + 20, base + 40),
               ("train.backward", 1, base + 300, base + 700), ("kernel.ff.bwd", 2, base + 320, base + 360), ("train.update", 1, base + 700, base + 890)]
    ops, launches, links = [], {}, {}
    corr = 0

    def op(thread, at, start, end, how="runtime"):
        nonlocal corr
        corr += 1
        ops.append((corr, start, end))
        if how == "runtime":
            launches[corr] = (thread, at)
        elif how == "link":
            links[corr] = (thread, at)

    for base in (0.0, 1000.0):
        op(1, base + 30, base + 100, base + 200)  # the FF forward kernel, launched inside kernel.ff.fwd
        op(1, base + 50, base + 200, base + 260)  # a library op of the forward
        op(2, base + 340, base + 400, base + 500)  # the FF backward kernel, on autograd's thread
        op(2, base + 380, base + 500, base + 540, how="link")  # an op of autograd's thread outside its kernel span: under train.backward
        op(1, base + 710, base + 700, base + 760)  # the optimizer's: its launch sits in train.update
    op(1, 0, 1950, 1960, how="lost")  # an operation whose launch the trace lacks
    recs = [_rec("kernel.ff.fwd", 20 + 1000 * k, [(100, 16), (16, 64)]) for k in range(2)]
    recs += [_rec("kernel.ff.bwd", 320 + 1000 * k, [(100, 16), (16, 64), (100, 16)]) for k in range(2)]
    return spans.Trace(sp, launches, ops, links), recs


def test_reduce_gives_ops_to_the_innermost_span_and_gaps_by_midpoint():
    trace, recs = synthetic()
    s = spans.reduce(trace, 2, 0.002, recs, {"kernel.ff.fwd": 2, "kernel.ff.bwd": 2})
    by = s["by_name"]
    assert by["train.step"]["count"] == 1 and by["kernel.ff.bwd"]["count"] == 1
    assert by["kernel.ff.fwd"]["busy_ms"] == pytest.approx(0.1) and by["kernel.ff.bwd"]["busy_ms"] == pytest.approx(0.1)
    assert by["train.forward"]["busy_ms"] == pytest.approx(0.06)  # its own op; the kernel's belongs to kernel.ff.fwd
    assert by["train.backward"]["busy_ms"] == pytest.approx(0.04)  # the linked op of the other thread
    assert by["train.forward"]["extent_ms"] == pytest.approx(0.16)  # 100 → 260: the nested kernel's op included
    assert by["train.backward"]["extent_ms"] == pytest.approx(0.14)  # 400 → 540, through the kernel span on thread 2
    assert by["train.update"]["extent_ms"] == pytest.approx(0.06)
    assert by["train.step"]["extent_ms"] == pytest.approx(0.66)  # 100 → 760
    assert s["ops_by_link"] == 2 and s["ops_unattributed"] == 1 and s["ops"] == 11
    assert s["kernel_busy_s"] + s["library_busy_s"] == pytest.approx(s["busy_s"])
    assert s["kernel_busy_s"] == pytest.approx(4 * 100e-6)
    # gaps: 260 → 400 (midpoint 330: kernel.ff.bwd, open on thread 2), 540 → 700 (620: train.backward), 760 → 1100 (930: no span), ...
    assert s["idle_by_span"]["kernel.ff.bwd"][0] == 2 and s["idle_by_span"]["train.backward"][0] == 2
    assert s["idle_by_span"]["no span"] == [1, pytest.approx(0.34)]  # 760 → 1100
    assert s["idle_by_span"]["train.update"] == [1, pytest.approx(0.19)]  # 1760 → 1950, midpoint 1855 in the second step's update
    ff = s["kernels"]["kernel.ff.fwd"]
    assert ff["launches"] == 2 and ff["device_ms"] == pytest.approx(0.2)
    assert ff["least_ms"] == pytest.approx(2e3 * kernel_work.least_s("kernel.ff.fwd", [(100, 16), (16, 64)], BF16))
    assert s["launched"] == {"kernel.ff.bwd": 2, "kernel.ff.fwd": 2}


def test_readers_of_the_spans_field():
    trace, recs = synthetic()
    record = {"kind": "train", "spans": spans.reduce(trace, 2, 0.002, recs)}
    assert spans.extent_ms(record, "train", "train.backward") == pytest.approx(0.14)
    assert spans.extent_ms(record, "serve", "train.backward") is None and spans.extent_ms(record, "train", "recognize.decode") is None
    least = sum(k["least_ms"] for k in record["spans"]["kernels"].values())
    assert spans.kernel_roofline(record, "train") == pytest.approx(100 * least / 0.4)
    assert spans.library_share(record, "train") == pytest.approx(100 * record["spans"]["library_busy_s"] / record["spans"]["busy_s"])
    assert 0 < spans.library_share(record, "train") < 100
    assert spans.kernel_roofline({"kind": "train"}, "train") is None  # a parent's record has no spans field
    record["spans"]["kernels"]["kernel.ff.fwd"]["least_ms"] = None  # shapes not paired: left out of the sum
    assert spans.kernel_roofline(record, "train") == pytest.approx(100 * record["spans"]["kernels"]["kernel.ff.bwd"]["least_ms"] / 0.2)


def test_unpaired_records_leave_the_least_time_out():
    trace, recs = synthetic()
    s = spans.reduce(trace, 2, 0.002, recs[:1] + recs[2:])
    assert s["kernels"]["kernel.ff.fwd"]["least_ms"] is None and s["kernels"]["kernel.ff.bwd"]["least_ms"] is not None


def test_profile_on_the_cpu_profiler_reads_the_program_spans():
    """The profiler adapter over a real CPU trace: the program's spans are found by name (no device operation here)."""
    from tensorflowasr_tpu_torch.utils import tracing

    with tracing.collect() as records, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("train.step"), tracing.span("train.forward"):
            torch.ones(8).sum()
    trace = spans.from_profiler(prof.events(), {r.name for r in records})
    assert sorted(s[0] for s in trace.spans) == ["train.forward", "train.step"] and trace.ops == []
    s = spans.reduce(trace, 1, 0.001, records)
    assert s["by_name"]["train.step"]["count"] == 1 and s["busy_s"] == 0 and math.isfinite(s["wall_s"])
