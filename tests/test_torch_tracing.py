"""The port's spans and launch counts (``utils/tracing.py``), on the CPU.

Off (outside ``collect()``), ``span`` is one shared null context that
records nothing and never enters ``record_function``; a kernel span only
counts. On, spans nest by thread, a span opened on another thread (as
autograd's backward threads do) takes the open phase as its parent, and
``record_function`` is entered only while a profiler runs. A 2-block
Conformer-T's training step and ``recognize`` (and a Conformer-CTC's) give
the documented trees,
and ``torch.export`` with collection on (and a profiler running) gives a
graph with no profiler operation.
"""

import threading

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch import export, schemas
from tensorflowasr_tpu_torch.models.ctc.base import recognize as ctc_recognize
from tensorflowasr_tpu_torch.models.ctc.conformer import ConformerCtc
from tensorflowasr_tpu_torch.models.transducer.base import recognize
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tensorflowasr_tpu_torch.training.trainer import Trainer
from tensorflowasr_tpu_torch.utils import tracing
from tests.test_torch_ctc_slice import CONFORMER_CFG as CTC_CFG
from tests.test_torch_slice import TINY_CFG

TRAIN_PHASES = ["train.zero_grad", "train.forward", "train.loss", "train.backward", "train.update"]


@pytest.fixture
def no_record_function(monkeypatch):
    """``record_function`` patched to raise wherever the spans could reach it."""

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def _tree(records) -> dict:
    """{name: [child names in opening order]} over the records (one entry a name; the last one wins)."""
    by_id = {r.id: r for r in records}
    tree = {r.name: [] for r in records}
    for r in records:
        if r.parent is not None:
            tree[by_id[r.parent].name].append(r.name)
    return tree


def test_off_is_one_null_context_and_records_nothing(no_record_function):
    x = torch.zeros(3, 4)
    before = tracing.launches["kernel.test.fwd"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        spans = [tracing.span("recognize", x), tracing.span("train.step")]
        assert all(s is tracing.NULL for s in spans)
        with spans[0], spans[1]:
            pass
        with tracing.kernel("kernel.test.fwd", x) as k:
            assert k is tracing.kernel("kernel.test.fwd")  # one counting object a name, shared
    assert tracing.launches["kernel.test.fwd"] == before + 1
    with pytest.raises(RuntimeError), tracing.kernel("kernel.test.fwd", x):
        raise RuntimeError("the launch failed")
    assert tracing.launches["kernel.test.fwd"] == before + 1  # a launch that raised is not counted


def test_nesting_ids_parents_and_threads(no_record_function):
    x = torch.zeros(2, 5, dtype=torch.bfloat16)
    seen = {}

    def worker():  # a thread with no span of its own, as autograd's device threads
        with tracing.span("kernel.worker", x) as s:
            seen["worker"] = s

    with tracing.collect() as records:
        with tracing.span("train.step") as step:
            with tracing.span("train.backward") as bwd:
                t = threading.Thread(target=worker)
                t.start()
                t.join()
                with tracing.kernel("kernel.test.bwd", x, None, torch.ones(3)) as k:
                    pass
        with tracing.span("recognize") as req:
            pass
    assert tracing.span("recognize") is tracing.NULL  # off again once collect() closes
    assert [r.name for r in records] == ["train.step", "train.backward", "kernel.worker", "kernel.test.bwd", "recognize"]
    assert step.parent is None and step.root == step.id and req.parent is None and req.root == req.id != step.id
    assert bwd.parent == step.id and k.parent == bwd.id and all(r.root == step.id for r in (bwd, k, seen["worker"]))
    assert seen["worker"].parent == bwd.id and seen["worker"].thread != step.thread  # the open phase of the other thread
    assert k.shapes == [(2, 5), (3,)] and k.dtypes == ["bfloat16", "float32"]  # None passed is left out
    assert len({r.id for r in records}) == len(records)
    assert all(r.start_ns <= r.end_ns for r in records) and bwd.start_ns <= seen["worker"].start_ns <= seen["worker"].end_ns <= bwd.end_ns


def test_a_span_in_autograds_backward_takes_the_phase(no_record_function):
    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            with tracing.span("kernel.twice.bwd", g):
                return 2 * g

    x = torch.ones(4, requires_grad=True)
    with tracing.collect() as records:
        with tracing.span("train.step"):
            y = Twice.apply(x).sum()
            with tracing.span("train.backward") as bwd:
                y.backward()
    inner = next(r for r in records if r.name == "kernel.twice.bwd")
    assert inner.parent == bwd.id and torch.equal(x.grad, torch.full((4,), 2.0))


def test_record_function_only_while_a_profiler_runs():
    with tracing.collect():
        with tracing.span("train.step") as s:
            assert s._rf is None  # no profiler: no record_function
    with tracing.collect() as records, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("train.step"), tracing.kernel("kernel.test.fwd"):
            torch.ones(3).sum()
    names = [e.name for e in prof.events()]
    assert names.count("train.step") == 1 and names.count("kernel.test.fwd") == 1 and len(records) == 2


def test_phases_close_at_the_marks_and_on_a_raise():
    marks = []
    with tracing.collect() as records:
        phases = tracing.Phases(marks.append, "train.forward", {"forward": "train.loss"})
        phases.mark("forward")
        phases.mark("loss")
        phases.close()
        with pytest.raises(ValueError), tracing.span("train.step"):
            phases = tracing.Phases(None, "train.forward", {})
            try:
                raise ValueError("the forward raised")
            finally:
                phases.close()
        with tracing.span("recognize") as after:
            pass
    assert marks == ["forward", "loss"] and [r.name for r in records] == ["train.forward", "train.loss", "train.step", "train.forward", "recognize"]
    assert all(r.end_ns is not None for r in records) and after.parent is None


def _tiny(seed=3):
    model = Conformer.from_config(TINY_CFG, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _audio(rng, b=2, n=6000):
    return torch.tensor((rng.standard_normal((b, n)) * 0.5).astype(np.float32)), torch.tensor([n, n - 1700])


def test_train_step_and_recognize_give_the_documented_trees():
    rng = np.random.default_rng(5)
    model = _tiny()
    trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": 1e-3}}, device="cpu", on_phase=lambda p: marks.append(p))
    state = trainer.init_state()
    sig, lens = _audio(rng)
    labels = torch.tensor(rng.integers(1, TINY_CFG["vocab_size"], (2, 4)))
    llen = torch.tensor([4, 3])
    labels[1, 3] = 0
    preds = torch.cat([torch.zeros((2, 1), dtype=torch.int64), labels], dim=1)
    batch = schemas.TrainData(schemas.TrainInput(sig, lens, preds, llen + 1), schemas.TrainLabel(labels, llen))
    marks = []
    with tracing.collect() as records:
        state, metrics = trainer.train_step(state, batch)
        model.eval()
        out = recognize(model, schemas.PredictInput(sig, lens))
    assert marks == ["forward", "loss", "update"] and torch.isfinite(metrics["loss"])  # the hook fires where it did
    tree = _tree(records)
    assert tree["train.step"] == TRAIN_PHASES and tree["recognize"] == ["recognize.encode", "recognize.decode"]
    step = next(r for r in records if r.name == "train.step")
    assert step.shapes == [tuple(sig.shape), tuple(labels.shape)]
    assert [r.name for r in records if r.parent is None] == ["train.step", "recognize"]
    assert all(r.root == step.id for r in records if r.name.startswith("train.")) and out.tokens.shape[0] == 2
    ctc = ConformerCtc.from_config(CTC_CFG, device="cpu").eval()
    with tracing.collect() as records:
        ctc_recognize(ctc, schemas.PredictInput(sig, lens))
    assert _tree(records) == {"recognize": ["recognize.encode", "recognize.decode"], "recognize.encode": [], "recognize.decode": []}


def test_export_with_collection_on_holds_no_profiler_op():
    model = _tiny().eval()
    sig, lens = _audio(np.random.default_rng(6), b=1, n=4000)
    fn = export.make_inference_fn(model)
    with tracing.collect() as records, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        program = torch.export.export(fn, (sig, lens[:1]))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert not [t for t in targets if "profiler" in t or "record_function" in t], sorted(targets)
    assert records == []  # every span is the null context under export
