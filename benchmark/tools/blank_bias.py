"""Chooses a configuration's constant blank bias on the card: the blank
logit's bias at which greedy decoding of the serving mix's lengths emits ``--target`` tokens per audio second, averaged over the
weight seeds ``--seeds`` (the training cells' rule: the blank row zero,
``reference/model.py:make_weights``; by default the configuration's served
model, ``harness/serve.py:served_weights``, over the traffic seeds
``--traffic-seeds``; a random joint otherwise emits up to its 2T + 1
budget), each over
``--requests`` requests. Prints one JSON line per value tried, the choice,
each run's rate at it and the rates at the choice ± 0.01 and ± 0.05 (how
flat the curve lies there); the choice is then written into the
configuration file by hand. ``--grid lo,hi,step`` prints the rate at each
bias of a grid instead.

    python3 benchmark/tools/blank_bias.py --config conformer_l --traffic serve_lstest_b16 [--target 4.0] [--grid 1.5,3.0,0.05]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import common  # noqa: E402

common.set_environment()

import torch  # noqa: E402

from benchmark.harness import serve  # noqa: E402
from benchmark.harness import traffic as tr  # noqa: E402
from benchmark.reference import model as rm  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", default="serve_lstest_b16")
    p.add_argument("--target", type=float, default=4.0)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--seeds", default=None, help="comma-separated weight seeds (each with its own traffic seed)")
    p.add_argument("--traffic-seeds", default=None, help="comma-separated traffic seeds for the served model")
    p.add_argument("--grid", default=None, help="lo,hi,step: the rate at each bias of the grid")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    config, traffic = common.load("configs", args.config), common.load("traffic", args.traffic)
    a = rm.arch_of(config["model_config"])
    runs = []  # (label, program, requests)
    if args.seeds:
        for seed in (int(x) for x in args.seeds.split(",")):
            runs.append((seed, serve.Program(config, rm.make_weights(a, seed, 0.0, dev), dev), tr.serve_pool(traffic, seed, dev)[:args.requests]))
    else:
        served = config["serve_model"]["weights_seed"]
        prog = serve.Program(config, serve.served_weights(a, config, dev, blank_bias=0.0), dev)
        for seed in (int(x) for x in (args.traffic_seeds or str(served)).split(",")):
            runs.append((seed, prog, tr.serve_pool(traffic, seed, dev)[:args.requests]))
    audio_s = [sum(sum(it["samples"]) for it in pool) / traffic["sample_rate"] for _, _, pool in runs]

    def rates(bias: float) -> list:
        out = []
        for (_, prog, pool), secs in zip(runs, audio_s):
            with torch.no_grad():
                prog.model.joint.vocab.bias[a.blank] = bias
            out.append(sum(len(r) for it in pool for r in prog.serve(it)) / secs)
        return out

    def rate(bias: float) -> float:
        each = rates(bias)
        print(json.dumps({"config": args.config, "blank_bias": bias, "tokens_per_audio_s": sum(each) / len(each),
                          "by_run": [round(r, 4) for r in each]}), flush=True)
        return sum(each) / len(each)

    if args.grid:
        lo, hi, step = (float(x) for x in args.grid.split(","))
        for i in range(int(round((hi - lo) / step)) + 1):
            rate(round(lo + i * step, 6))
        return 0
    lo, hi = -1.0, 1.0
    while rate(lo) <= args.target:
        lo -= hi - lo
    while rate(hi) > args.target:
        hi += hi - lo
    for _ in range(10):  # bisection: the rate falls as the bias grows
        mid = 0.5 * (lo + hi)
        if rate(mid) > args.target:
            lo = mid
        else:
            hi = mid
    choice = round(0.5 * (lo + hi), 3)
    each = rates(choice)
    around = {f"{d:+.2f}": sum(rates(choice + d)) / len(runs) for d in (-0.05, -0.01, 0.01, 0.05)}
    print(json.dumps({"config": args.config, "choice": choice, "tokens_per_audio_s": sum(each) / len(each), "by_run": dict(zip((r[0] for r in runs), each)),
                      "around": around, "card": torch.cuda.get_device_name(0), "power_limit_w": common.power_limit_w()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
