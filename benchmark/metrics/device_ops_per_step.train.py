"""Device operations (kernels, copies and sets) in the profiled sub-window, per step."""

from benchmark.harness import readers


def read(record: dict):
    return readers.device_ops(record, "train")
