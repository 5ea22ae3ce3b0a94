"""``BENCHMARK.json`` against the benchmark's contract, the files it names,
and what the run imports (nothing of the JAX package; the reference nothing
of the program); the run gives no result without a card."""

from __future__ import annotations

import importlib
import json
import math
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return common.manifest()


def e2e_of(bench, cell) -> set:
    return {m["name"] for m in bench["end_to_end"] if common.reports(m, cell, set())}


def driver(name: str):
    return importlib.import_module(f"benchmark.harness.{name}")


def drivers(bench) -> dict:
    """The drivers that the cells' traffic files name, by name."""
    return {t: driver(t) for t in {common.load("traffic", w["traffic"])["driver"] for w in bench["workloads"]}}


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"] and bench["paths"] == ["benchmark"]
    for kind, keys in (("configs", {"name", "source", "file", "reduced", "why"}), ("workloads", {"name", "config", "traffic", "chips", "why"}),
                       ("end_to_end", {"name", "unit", "better", "bound", "source"}), ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
        for e in bench[kind]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]), e["name"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES, m
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25, m
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for text in [e["why"] for e in bench["configs"] + bench["workloads"]] + [m["layer"] for m in bench["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_file_is_found_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cfg = common.load("configs", w["config"])
        assert configs[w["config"]]["file"] == f"benchmark/configs/{w['config']}.json"
        assert cfg["source"] == configs[w["config"]]["source"] and cfg["reduced"] == configs[w["config"]]["reduced"]
        traffic = common.load("traffic", w["traffic"])
        assert (common.BENCH / "harness" / f"{traffic['driver']}.py").is_file()
        assert set(common.load("limits", w["name"])) == set(driver(traffic["driver"]).CHECKS), w["name"]
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    for m in bench["per_layer"]:
        assert (common.BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_every_cell_reports_what_the_contract_asks(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        mine = e2e_of(bench, w)
        measures = driver(common.load("traffic", w["traffic"])["driver"]).MEASURES
        assert mine <= set(measures), (w["name"], mine, measures)
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        layers = [m for m in bench["per_layer"] if common.reports(m, w, mine)]
        assert layers, w["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for name in m["workloads"]:
            cell = next(w for w in bench["workloads"] if w["name"] == name)
            assert m["moves"] in e2e_of(bench, cell), (m["name"], name)


def test_run_length_fits_the_check(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_readers_read_their_own_kind_only(bench):
    """Each reader gives a value on the record of the drivers of the cells it is reported in (each driver's
    ``EXAMPLE_RECORD``), and nothing on any other driver's record."""
    from benchmark.run import metric_reader

    peaks = common.PEAKS["NVIDIA H100 80GB HBM3"]
    by_driver = drivers(bench)
    records = {name: {**d.EXAMPLE_RECORD, "peaks": peaks} for name, d in by_driver.items()}
    assert len({r["kind"] for r in records.values()}) == len(records)
    for m in bench["per_layer"]:
        read = metric_reader(m["name"])
        mine = {common.load("traffic", w["traffic"])["driver"] for w in bench["workloads"] if common.reports(m, w, e2e_of(bench, w))}
        assert mine, m["name"]
        for name, record in records.items():
            value = read(record)
            if name in mine:
                assert value is not None and math.isfinite(value) and value > 0, m["name"]
                if m["unit"] == "%":
                    assert value <= 100.0
            else:
                assert value is None, (m["name"], name)


def _python(code: str, cwd=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=cwd or common.ROOT)


def test_the_run_path_imports_nothing_of_the_jax_package():
    """A tiny run of both drivers in a fresh process: no module whose top-level name is one of the JAX package's is loaded
    (compared whole: the port's own name begins with the JAX package's)."""
    code = """
import sys, json, torch
torch.set_num_threads(2)
from benchmark.tests import tiny
from benchmark.harness import common, serve, train
train.run(tiny.context(tiny.TRAIN, seconds=0.2))
serve.run(tiny.context(tiny.SERVE, seconds=0.2))
tops = sorted({m.split('.', 1)[0] for m in sys.modules})
print(json.dumps({"bad": common.forbidden_loaded(), "port": "tensorflowasr_tpu_torch" in tops}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "port": True}


def test_the_reference_imports_nothing_of_the_program():
    code = """
import sys, torch
from benchmark.reference import loss, model, optim
from benchmark.tests import tiny
a = model.arch_of(tiny.config()["model_config"])
w = model.make_weights(a, 1, 0.0, torch.device("cpu"))
enc, lens = model.encode(a, w, torch.randn(2, 8000) * 0.1, torch.tensor([8000, 6000]))
loss.greedy_decode(a, w, enc, lens)
print(sorted({m.split('.', 1)[0] for m in sys.modules} & {"tensorflowasr_tpu_torch", "tensorflowasr_tpu", "jax", "jaxlib", "flax", "optax", "orbax"}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    args = ["benchmark/run.py", "--workload", "conformer_l.train", "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=300, cwd=common.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == "" and "CUDA" in out.stderr
    # a directory with BENCHMARK.json and the benchmark's files only: no result either
    shutil.copytree(common.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
