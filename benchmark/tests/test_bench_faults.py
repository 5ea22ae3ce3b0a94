"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on the
CPU at a tiny width, once sound and once for each fault a cell can have (a
step that leaves the state unchanged, half of the batch left out with the
mean taken over the rest, a served token altered where it is produced),
judged by tight f32 limits and by each cell's committed limits. The
exchange between chips does not exist in a one-chip cell."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import common, serve, train
from benchmark.run import finish
from benchmark.tests import tiny



def limits_of(kind: str, own: dict) -> dict:
    """The tight limits of an f32 program against the f32 reference, and the committed limits of every cell the driver runs."""
    cells = [w["name"] for w in common.manifest()["workloads"] if common.load("traffic", w["traffic"])["driver"] == kind]
    return {"f32": own, **{c: common.load("limits", c) for c in cells}}


TRAIN_LIMITS = limits_of("train", {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4})
SERVE_LIMITS = limits_of("serve", {"served_gap": 1e-4})


def frozen_state(prog):
    prog.state.optimizer.base.step = lambda *args, **kwargs: None  # the update leaves every parameter and moment as it was
    return prog


def half_batch(prog):
    step = prog.step

    def broken(item):
        h = len(item["samples"]) // 2
        return step({k: (v[:h] if isinstance(v, (torch.Tensor, list)) else v) for k, v in item.items()})

    prog.step = broken
    return prog


def altered_token(prog):
    serve_fn = prog.serve

    def broken(item):
        rows = [r.clone() for r in serve_fn(item)]
        for r in rows:
            if len(r):
                r[0] = r[0] % 15 + 1
        return rows

    prog.serve = broken
    return prog


def run(driver, traffic, limits, plant=None, seed=31337, blank_bias=None):
    cfg = tiny.config()
    if blank_bias is not None:
        cfg["blank_bias"] = blank_bias
    ctx = tiny.context(traffic, seed=seed, cfg=cfg, seconds=0.3, plant=plant)
    out, numbers = driver.run(ctx)
    result, checks = finish(ctx, out, numbers, limits)
    return result, checks


@pytest.mark.parametrize("limits", list(TRAIN_LIMITS))
@pytest.mark.parametrize("plant", [None, frozen_state, half_batch], ids=["sound", "state_unchanged", "half_batch"])
def test_training_faults_are_not_correct(plant, limits):
    result, checks = run(train, tiny.TRAIN, TRAIN_LIMITS[limits], plant)
    assert result["correct"] is (plant is None), checks
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("limits", list(SERVE_LIMITS))
@pytest.mark.parametrize("plant", [None, altered_token], ids=["sound", "token_altered"])
def test_serving_faults_are_not_correct(plant, limits):
    result, checks = run(serve, tiny.SERVE, SERVE_LIMITS[limits], plant, seed=4242)
    assert result["correct"] is (plant is None), checks
    assert result["attempted"] >= 1
