"""The profiled requests' least time (each the larger of its useful operations at the bf16 peak and
its irreducible bytes at the HBM rate) over the device's busy time in the profiled sub-window, in %."""

from benchmark.harness import readers


def read(record: dict):
    return readers.roofline(record, "serve")
