"""The share of the profiled sub-window's wall in which no operation ran on the device, in %."""

from benchmark.harness import readers


def read(record: dict):
    return readers.idle_share(record, "serve")
