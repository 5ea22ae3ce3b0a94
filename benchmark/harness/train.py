"""Training cells: ``Trainer.train_step`` driven as ``Trainer.fit`` drives it.

Set-up builds the model through ``build_model``, loads the benchmark's
weights, makes the trainer and its state (dropout and augment streams from
the run's step seed) and the pool of batches in pinned host memory, and
takes the first three steps on three distinct batches through the window's
own call: they warm up every shape (the batches share one padded shape) and
are the steps the reference follows. After them, ``gc.collect(); gc.freeze()``
as ``fit`` does, then the window: steps issued back to back, cycling the
pool, no synchronise until the one that ends the window.

The check, once the window has closed and the program's state is freed:
the reference takes the same three steps from the same weights, batches
and seeds in float32, and the losses, the first gradient of each leaf (from
Adam's first moment after step 1) and each leaf's change over the three
steps are compared (:func:`compare`).
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from ..reference import loss as rl
from ..reference import model as rm
from ..reference import optim as ro
from . import common, flops, trace
from . import traffic as tr

KIND = "train"  # the kind of the record a traced run hands to the metric readers
CHECKS = ("loss_gap", "grad_gap", "change_gap")  # the numbers compared, each with its limit in benchmark/limits/<cell>.json
MEASURES = ("train_audio_s_per_s", "setup_s")  # the end-to-end metrics a run measures
# A traced run's record, with every field this driver writes (the readers' tests read it).
EXAMPLE_RECORD = {"kind": KIND, "window_s": 20.0, "steps": 57, "flops": 6.7e14, "phase_ms": {"forward": 90.0, "loss": 13.0, "backward_update": 250.0},
                  "sub": {"wall_s": 1.3, "busy_s": 1.0, "ops": 16650, "n": 3, "least_s": 0.04, "device_ops": [], "idle_gaps": []}}
CHECK_STEPS = 3
PROFILED_STEPS = 3
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_program(config: dict, device):
    from tensorflowasr_tpu_torch.models import build_model

    return build_model(config["model_config"], dtype=DTYPES[config["compute_dtype"]], device=device, rnn_impl=config["rnn_impl"])


def load_weights(model, weights: dict) -> None:
    """The benchmark's weights into the program; its leaves must be the configuration's, name for name and shape for shape."""
    have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in weights.items()}
    if have != want:
        raise ValueError(f"the program's leaves differ from the configuration's: {sorted(set(have.items()) ^ set(want.items()))[:6]}")
    model.load_state_dict(weights, strict=True)


def train_data(item: dict):
    from tensorflowasr_tpu_torch import schemas

    return schemas.TrainData(schemas.TrainInput(item["audio"], item["audio_len"], item["preds"], item["preds_len"]),
                             schemas.TrainLabel(item["labels"], item["labels_len"]))


def seeds(seed: int) -> dict:
    return {"content": int(seed), "weights": int(seed) + 1, "steps": int(seed) + 2}


class Program:
    """The program's training object: model, trainer and state, built once and handed from set-up to the window."""

    def __init__(self, config: dict, weights: dict, step_seed: int, device, on_phase=None, mark=lambda part: None):
        from tensorflowasr_tpu_torch.training.trainer import Trainer

        self.model = build_program(config, device)
        load_weights(self.model, weights)
        mark("model")
        self.trainer = Trainer(self.model, config["optimizer"], device=device, on_phase=on_phase)
        self.state = self.trainer.init_state(seed=step_seed)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.beta1 = float(config["optimizer"]["config"].get("beta_1", 0.9))

    def step(self, item: dict):
        self.state, metrics = self.trainer.train_step(self.state, train_data(item))
        return metrics["loss"]

    def first_steps(self, items: list, weights: dict) -> dict:
        """The check steps: each step's loss, each leaf's first gradient norm (Adam's first moment after step 1 over 1 − β₁) and
        each leaf's change over the steps."""
        params = [p for _, p in self.model.named_parameters()]
        losses, grad = [], None
        for i, item in enumerate(items):
            losses.append(float(self.step(item)))
            if i == 0:  # a leaf the optimizer holds no moment of reads 0
                state = self.state.optimizer.base.state
                grad = [float(state[p]["exp_avg"].norm()) / (1.0 - self.beta1) if "exp_avg" in state.get(p, {}) else 0.0 for p in params]
        change = torch.stack(torch._foreach_norm(torch._foreach_sub([p.detach() for p in params], [weights[n] for n in self.names]))).tolist()
        return {"loss": losses, "grad": dict(zip(self.names, grad)), "change": dict(zip(self.names, change))}


def reference_steps(a: rm.Arch, optimizer: dict, weights: dict, items: list, step_seed: int, q: rm.Operands, rows: int) -> dict:
    """The reference's check steps from the same weights, batches and step seed: forward, loss (the joint and the loss in blocks of
    ``rows`` utterances), backward, Adam. The same numbers as :meth:`Program.first_steps`."""
    dev = next(iter(weights.values())).device
    w = {k: v.detach().clone().requires_grad_(not k.endswith(("running_mean", "running_var"))) for k, v in weights.items()}
    params = {k: v for k, v in w.items() if v.requires_grad}
    opt = ro.Adam(optimizer)
    streams = rm.Streams(step_seed, a.dropout)
    losses, grad = [], None
    for i, item in enumerate(items):
        audio, alen = item["audio"].to(dev), item["audio_len"].to(dev)
        labels, u = item["labels"].to(dev), item["labels_len"].to(dev)
        enc, elens = rm.encode(a, w, audio, alen, q, streams)
        pred = rm.predict(a, w, item["preds"].to(dev), item["preds_len"].to(dev), q)
        ep, pp = rm.project_encoder(w, enc, q), rm.project_prediction(w, pred, q)
        ep_d, pp_d = ep.detach().requires_grad_(), pp.detach().requires_grad_()
        b, t_max = enc.shape[0], enc.shape[1]
        safe_t = torch.minimum(torch.maximum(elens.clamp(min=1), u), torch.tensor(t_max, device=dev))
        total = 0.0
        for s in range(0, b, rows):
            blk = slice(s, min(b, s + rows))
            logits = rm.joint_logits(w, ep_d[blk][:, :, None], pp_d[blk][:, None], q)
            part = rl.rnnt_losses(logits, labels[blk], safe_t[blk], u[blk], a.blank).sum() / b
            part.backward()
            total += float(part.detach())
            del logits, part
        torch.autograd.backward([ep, pp], [ep_d.grad, pp_d.grad])
        grads = {k: p.grad for k, p in params.items()}
        if i == 0:
            grad = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(params, grads)
        for p in params.values():
            p.grad = None
        losses.append(total)
        del enc, pred, ep, pp, ep_d, pp_d
    change = {k: float((p.detach() - weights[k]).norm()) for k, p in params.items()}
    return {"loss": losses, "grad": grad, "change": change, "params": {k: p.detach() for k, p in params.items()}}


def compare(prog: dict, ref: dict) -> dict:
    """The compared numbers. loss_gap: the largest |program − reference| / |reference| of the step losses. grad_gap and change_gap:
    over the leaves, the largest gap between the program's norm and the reference's, over the larger of the reference's norm of
    that leaf and of the median leaf. change_gap leaves out the leaves whose reference gradient is under a thousandth of the median
    leaf's (they move by round-off alone, as a key bias under softmax)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))

    def worst(key, names):
        med = statistics.median(ref[key][n] for n in names)
        return max(abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med, 1e-30) for n in names)

    names = list(ref["grad"])
    gmed = statistics.median(ref["grad"].values())
    moving = [n for n in names if ref["grad"][n] >= 1e-3 * gmed]
    return {"loss_gap": loss_gap, "grad_gap": worst("grad", names), "change_gap": worst("change", moving)}


def check_numbers(ctx, a: rm.Arch, weights: dict, items: list, prog: dict) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference_steps(a, ctx.config["optimizer"], weights, items, seeds(ctx.seed)["steps"], rm.F32, ctx.config["reference_rows"])
    return compare(prog, ref)


def run(ctx) -> tuple[dict, dict]:
    """One run of a training cell; returns (result without checks, checks)."""
    a = rm.arch_of(ctx.config["model_config"])
    s = seeds(ctx.seed)
    dev = ctx.device
    weights = rm.make_weights(a, s["weights"], ctx.config["blank_bias"], dev)
    ctx.mark("weights")
    events = []
    on_phase = (lambda phase: events[-1].append(_event())) if ctx.trace else None
    prog = ctx.plant(Program(ctx.config, weights, s["steps"], dev, on_phase, ctx.mark))
    ctx.mark("optimizer")  # torch.optim's first parameter group imports torch._dynamo
    pool = tr.train_pool(ctx.traffic, a.vocab, s["content"], dev)
    ctx.mark("pool")
    work = [(flops.train_step_flops(a, it["samples"], it["label_counts"]),
             flops.train_step_bytes(a, len(it["samples"]), it["audio"].shape[1], it["labels"].shape[1]), sum(it["samples"]) / ctx.traffic["sample_rate"])
            for it in pool]
    if ctx.trace:
        events.append([])  # the check steps' marks are not read
    got = prog.first_steps(pool[:CHECK_STEPS], weights)
    ctx.mark("check_steps")
    gc.collect()
    gc.freeze()
    _sync(dev)
    start = time.perf_counter()
    setup_s = start - ctx.t0
    losses, audio_s, flop, n, i = [], 0.0, 0.0, 0, CHECK_STEPS
    while time.perf_counter() - start < ctx.seconds:
        k = i % len(pool)
        if ctx.trace:
            events.append([_event()])
        losses.append(prog.step(pool[k]))
        audio_s += work[k][2]
        flop += work[k][0]
        n, i = n + 1, i + 1
    _sync(dev)
    wall = time.perf_counter() - start
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum()) if losses else 0
    record = {"kind": KIND, "window_s": wall, "steps": n, "flops": flop}
    if ctx.trace:
        record["phase_ms"] = _phases(events[1:])
        order = [(i + j) % len(pool) for j in range(PROFILED_STEPS)]
        record["sub"] = trace.profile(torch, lambda j: prog.step(pool[order[j]]), PROFILED_STEPS)
        record["sub"]["least_s"] = sum(max(work[k][0] / ctx.peaks["flops"], work[k][1] / ctx.peaks["bytes"]) for k in order)
    device = common.device_record(torch, 1)
    del prog, losses
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    e2e = {"train_audio_s_per_s": audio_s / wall, "setup_s": setup_s}
    checks_at = check_numbers(ctx, a, weights, pool[:CHECK_STEPS], got)
    return {"attempted": n, "failed": failed, "e2e": e2e, "record": record, "device": device}, checks_at


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _phases(steps: list) -> dict:
    """Mean ms of the window's steps: start → "forward" → "loss" → "update"."""
    fwd, loss, upd = [], [], []
    for marks in steps:
        if len(marks) == 4:
            fwd.append(marks[0].elapsed_time(marks[1]))
            loss.append(marks[1].elapsed_time(marks[2]))
            upd.append(marks[2].elapsed_time(marks[3]))
    mean = lambda v: sum(v) / len(v) if v else math.nan
    return {"forward": mean(fwd), "loss": mean(loss), "backward_update": mean(upd)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()
