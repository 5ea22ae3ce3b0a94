"""Mean ms, over the window's steps, from the trainer's "loss" mark to its "update" mark (CUDA events)."""

from benchmark.harness import readers


def read(record: dict):
    return readers.phase_ms(record, "backward_update")
