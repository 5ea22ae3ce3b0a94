"""The profiled sub-window of a traced run: ``torch.profiler`` over a few
steps or requests after the timed window, reduced to the device's busy time
(the union of every kernel, copy and set interval; the device-side ranges of
host annotations such as ``Optimizer.step`` are left out), the count of device
operations, the operations that took the most device time, and the longest
idle gaps, each named by the innermost host operation running at its middle."""

from __future__ import annotations

import time


def _union(intervals: list) -> tuple[float, list]:
    """(covered length, merged intervals) of [(start, end)], sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def profile(torch, fn, n: int, top: int = 10) -> dict:
    """Runs ``fn(i)`` for i < n under the profiler between two synchronises; times in seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]  # a range's device shadow is no operation
    host = [e for e in events if e.device_type == DeviceType.CPU]
    busy_us, merged = _union([(e.time_range.start, e.time_range.end) for e in device])
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
    gaps = sorted(((start - end, 0.5 * (end + start)) for (_, end), (start, _) in zip(merged, merged[1:])), reverse=True)[:top]
    named = []
    for length, mid in gaps:
        around = [h for h in host if h.time_range.start <= mid <= h.time_range.end]
        label = min(around, key=lambda h: h.time_range.end - h.time_range.start).name if around else "no host operation"
        named.append([label[:120], length * 1e-6])
    ops = sorted(([k[:120], v] for k, v in by_name.items()), key=lambda kv: -kv[1])
    return {"wall_s": wall, "busy_s": busy_us * 1e-6, "ops": len(device), "n": n, "device_ops": ops[:top], "idle_gaps": named}
