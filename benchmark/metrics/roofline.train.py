"""The profiled steps' least time (each the larger of its useful operations at the bf16 peak and its
irreducible bytes at the HBM rate) over the device's busy time (the union of its operation intervals) in the profiled
sub-window, in %."""

from benchmark.harness import readers


def read(record: dict):
    return readers.roofline(record, "train")
