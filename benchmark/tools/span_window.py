"""The span sub-window of a cell on the card, beside the traced run's own
sub-window, for the per-layer metrics that read the program's spans
(``harness/spans.py``). The benchmark's runs do not run this file.

    python3 benchmark/tools/span_window.py --workload <cell> --seed <n> [--out FILE]

Set-up as the cell's harness module does it (the same weights, served model,
pool and warm-up; no reference check), then a few steps or requests to
settle and one profiled sub-window that is not kept (the profiler's own
first start), then three rounds of, in turns: the plain sub-window
(``harness/trace.py``, as a traced run profiles), the span sub-window
(``spans.profile``: the profiler with the program's spans collected), the
span sub-window, the plain one, each over as many steps or requests as a
traced run profiles (3 steps, each window its own next ones; or the same
8 requests). Prints one JSON line: the card and its power limit; the
walls of each sub-window and the medians' ratio less one (what collecting
spans costs under the profiler); the cell's span readings (``READS``), the
median over the span sub-windows and each; the checks below for every
span sub-window; and
with ``--out`` writes every span sub-window's ``spans`` field there.

Checks: kernel plus library busy time equals the sub-window's busy time
(within 1%); the five training phases' extents sum to within 10% of the
sub-window's wall a step (encode plus decode, of its wall a request); each
kernel span's count equals ``tracing.launches``' growth over the window;
``kernel_roofline`` at most 100% and ``library_share`` strictly between 0
and 100%. Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import common  # noqa: E402

common.set_environment()

import torch  # noqa: E402

from benchmark.harness import serve, spans, trace, train  # noqa: E402
from benchmark.harness import traffic as tr  # noqa: E402
from benchmark.reference import model as rm  # noqa: E402

PHASES = {"train": ["train.zero_grad", "train.forward", "train.loss", "train.backward", "train.update"],
          "serve": ["recognize.encode", "recognize.decode"]}
READS = {  # metric name → (kind, reading of the ``spans`` field)
    "backward_ms.train": ("train", lambda r: spans.extent_ms(r, "train", "train.backward")),
    "update_ms.train": ("train", lambda r: spans.extent_ms(r, "train", "train.update")),
    "kernel_roofline.train": ("train", lambda r: spans.kernel_roofline(r, "train")),
    "library_share.train": ("train", lambda r: spans.library_share(r, "train")),
    "encode_ms.serve": ("serve", lambda r: spans.extent_ms(r, "serve", "recognize.encode")),
    "decode_ms.serve": ("serve", lambda r: spans.extent_ms(r, "serve", "recognize.decode")),
    "kernel_roofline.serve": ("serve", lambda r: spans.kernel_roofline(r, "serve")),
    "library_share.serve": ("serve", lambda r: spans.library_share(r, "serve")),
}
SETTLE = 4  # steps or requests between the warm-up and the first sub-window
ROUNDS = 3  # rounds of the plain and span sub-windows, in turns


def train_program(ctx: dict, dev):
    a = rm.arch_of(ctx["config"]["model_config"])
    s = train.seeds(ctx["seed"])
    weights = rm.make_weights(a, s["weights"], ctx["config"]["blank_bias"], dev)
    prog = train.Program(ctx["config"], weights, s["steps"], dev)
    pool = tr.train_pool(ctx["traffic"], a.vocab, s["content"], dev)
    for item in pool[:train.CHECK_STEPS]:  # the warm-up steps of a run
        prog.step(item)
    n = train.PROFILED_STEPS
    return (lambda k: (lambda j: prog.step(pool[(k + j) % len(pool)]))), n, len(pool)


def serve_program(ctx: dict, dev):
    a = rm.arch_of(ctx["config"]["model_config"])
    s = train.seeds(ctx["seed"])
    pool = tr.serve_pool(ctx["traffic"], s["content"], dev)
    prog = serve.Program(ctx["config"], serve.served_weights(a, ctx["config"], dev), dev)
    prog.serve(max(pool, key=lambda it: it["audio"].shape[1]))
    n = serve.PROFILED_REQUESTS
    return (lambda k: (lambda j: prog.serve(pool[(k + j) % len(pool)]))), n, len(pool)


def checks(kind: str, s: dict, readings: dict) -> dict:
    out = {"kernel_plus_library_over_busy": (s["kernel_busy_s"] + s["library_busy_s"]) / s["busy_s"]}
    per = s["wall_s"] / s["n"] * 1e3
    out["phases_over_wall"] = sum(s["by_name"].get(p, {}).get("extent_ms", 0.0) for p in PHASES[kind]) / per
    counts = {k: v["launches"] for k, v in s["kernels"].items()}
    out["launches_equal_spans"] = counts == s["launched"]
    ok = abs(out["kernel_plus_library_over_busy"] - 1) <= 0.01 and abs(out["phases_over_wall"] - 1) <= 0.10 and out["launches_equal_spans"]
    for name, v in readings.items():
        if name.startswith("kernel_roofline"):
            ok = ok and v is not None and v <= 100
        if name.startswith("library_share"):
            ok = ok and v is not None and 0 < v < 100
        ok = ok and v is not None
    out["ok"] = bool(ok)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None, help="write every span sub-window's spans field here (JSON)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_window needs a CUDA card: no result", file=sys.stderr)
        return 2
    workload = common.cell(args.workload)
    ctx = {"config": common.load("configs", workload["config"]), "traffic": common.load("traffic", workload["traffic"]), "seed": args.seed}
    kind = ctx["traffic"]["driver"]
    dev = torch.device("cuda")
    at, n, size = (train_program if kind == "train" else serve_program)(ctx, dev)
    gc.collect()
    gc.freeze()
    settle = at(0)
    for j in range(SETTLE):
        settle(j)
    k = SETTLE if kind == "train" else SETTLE + n  # training: each sub-window its own next steps; serving: the same requests
    trace.profile(torch, at(k), n)  # the profiler's first start, not kept
    walls, fields = {"plain": [], "spans": []}, []
    for turn in ("plain", "spans", "spans", "plain") * ROUNDS:
        fn = at(k)
        if turn == "plain":
            walls["plain"].append(trace.profile(torch, fn, n)["wall_s"])
        else:
            fields.append(spans.profile(torch, fn, n))
            walls["spans"].append(fields[-1]["wall_s"])
        if kind == "train":
            k = (k + n) % size
    each = [{m: read({"kind": kind, "spans": f}) for m, (of, read) in READS.items() if of == kind} for f in fields]
    readings = {m: statistics.median(r[m] for r in each) if all(r[m] is not None for r in each) else None for m in each[0]}
    result = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(0), "power_limit_w": common.power_limit_w(),
              "n": n, "walls_s": walls, "on_cost": statistics.median(walls["spans"]) / statistics.median(walls["plain"]) - 1.0, "metrics": readings,
              "metrics_each": each, "checks": [checks(kind, f, r) for f, r in zip(fields, each)]}
    s = fields[0]
    print(f"{args.workload}: span extents and own busy time per {'step' if kind == 'train' else 'request'} (ms): "
          + json.dumps({k: [round(v["extent_ms"], 3), round(v["busy_ms"], 3)] for k, v in s["by_name"].items() if not k.startswith(spans.KERNEL)}),
          file=sys.stderr)
    print(f"{args.workload}: library operations by device ms over the window: " + json.dumps(s["library_top_ms"]), file=sys.stderr)
    print(f"{args.workload}: kernels (launches, device ms, least ms over the window): "
          + json.dumps({k: [v["launches"], round(v["device_ms"], 3), None if v["least_ms"] is None else round(v["least_ms"], 4)]
                        for k, v in s["kernels"].items()}), file=sys.stderr)
    print(f"{args.workload}: idle gaps by the span open at their midpoint (gaps, ms): " + json.dumps(s["idle_by_span"]), file=sys.stderr)
    print(f"{args.workload}: busy {s['busy_s']:.6f} s (kernel {s['kernel_busy_s']:.6f}, library {s['library_busy_s']:.6f}), "
          f"ops {s['ops']} ({s['ops_by_link']} by link, {s['ops_unattributed']} unattributed)", file=sys.stderr)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"result": result, "spans": fields}))
    print(json.dumps(result), flush=True)
    return 0 if all(c["ok"] for c in result["checks"]) else 1


if __name__ == "__main__":
    sys.exit(main())
