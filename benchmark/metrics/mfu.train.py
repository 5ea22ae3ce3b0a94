"""Useful operations of the window's training steps (3 × each utterance's forward at its real length,
``harness/flops.py``) over the window's seconds × the card's bf16 peak, in %."""

from benchmark.harness import readers


def read(record: dict):
    return readers.mfu(record, "train")
