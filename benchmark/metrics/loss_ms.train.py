"""Mean ms, over the window's steps, from the trainer's "forward" mark to its "loss" mark (CUDA events)."""

from benchmark.harness import readers


def read(record: dict):
    return readers.phase_ms(record, "loss")
