"""The control at a size a test run holds: the reference with every product's
operands in float8 e4m3 (the precision below the configurations' bf16), put
in the program's place, reads at least three times what the bf16 program
reads, on the numbers each cell compares (``tools/readings.py``'s modes, on
the CPU at a tiny width; the cells' own readings are taken on the card)."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests import tiny
from benchmark.tools import readings

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_card_cache(monkeypatch):
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_training_control_fails_where_the_program_passes(seed):
    cfg = tiny.config("bfloat16")
    program = readings.train_seed(cfg, tiny.TRAIN, seed, "program", CPU)
    control = readings.train_seed(cfg, tiny.TRAIN, seed, "control", CPU)
    assert control["loss_gap"] >= 3 * program["loss_gap"] and control["grad_gap"] >= 3 * program["grad_gap"], (program, control)


@pytest.mark.parametrize("seed", [5, 6])
def test_serving_control_fails_where_the_program_passes(seed):
    cfg = tiny.config("bfloat16")
    program = readings.serve_seed(cfg, tiny.SERVE, seed, "program", CPU)
    control = readings.serve_seed(cfg, tiny.SERVE, seed, "control", CPU)
    assert program["tokens"] > 0 and control["served_gap"] >= 3 * program["served_gap"], (program, control)
