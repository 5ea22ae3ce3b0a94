"""Mean ms, over the window's steps, from a step's start to the trainer's "forward" mark (CUDA events)."""

from benchmark.harness import readers


def read(record: dict):
    return readers.phase_ms(record, "forward")
