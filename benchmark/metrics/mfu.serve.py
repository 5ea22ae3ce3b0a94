"""Useful operations of the window's requests (the encoder over real frames, one joint evaluation a
decision, one prediction step a token; ``harness/flops.py``) over the window's seconds × the card's bf16 peak, in %."""

from benchmark.harness import readers


def read(record: dict):
    return readers.mfu(record, "serve")
