"""The readings that a cell's limits are set from, on the card at the cell's
own sizes, many seeds in one process (the benchmark's own runs never run
this). Each seed prints one JSON line with the compared numbers and
``correct``: what ``run.py`` decides from them with the cell's committed
limits (``benchmark/limits/<cell>.json``, through ``run.judge``, the
function its ``finish`` decides by), so a control or a fault is seen to
come out not correct.

    python3 benchmark/tools/readings.py --workload <cell> --mode <mode> --seeds 101,102,...

Modes:
- ``program``: the program as the cell runs it (the lower reading);
- ``control``: the reference with every product's operands in float8 e4m3
  (the precision below the configuration's bf16) put in the program's place;
- ``half_batch`` (training): the program given the first half of each batch,
  its mean taken over those rows, judged against the whole batch;
- ``token`` (serving): the program with the first served token of each
  utterance altered where it is produced.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import common  # noqa: E402

common.set_environment()

import torch  # noqa: E402

from benchmark.harness import serve, train  # noqa: E402
from benchmark.harness import traffic as tr  # noqa: E402
from benchmark.reference import loss as rl  # noqa: E402
from benchmark.reference import model as rm  # noqa: E402
from benchmark.run import judge  # noqa: E402

FP8 = rm.Operands("fp8")


def half(item: dict) -> dict:
    h = len(item["samples"]) // 2
    return {k: (v[:h] if isinstance(v, (torch.Tensor, list)) else v) for k, v in item.items()}


def train_seed(config: dict, traffic: dict, seed: int, mode: str, dev) -> dict:
    a = rm.arch_of(config["model_config"])
    s = train.seeds(seed)
    weights = rm.make_weights(a, s["weights"], config["blank_bias"], dev)
    items = tr.train_pool(traffic, a.vocab, s["content"], dev)[:train.CHECK_STEPS]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "control":
        got = train.reference_steps(a, config["optimizer"], weights, items, s["steps"], FP8, config["reference_rows"])
    else:
        prog = train.Program(config, weights, s["steps"], dev)
        got = prog.first_steps([half(it) for it in items] if mode == "half_batch" else items, weights)
        del prog
        gc.collect()
        torch.cuda.empty_cache()
    ref = train.reference_steps(a, config["optimizer"], weights, items, s["steps"], rm.F32, config["reference_rows"])
    return train.compare(got, ref)


def serve_seed(config: dict, traffic: dict, seed: int, mode: str, dev) -> dict:
    a = rm.arch_of(config["model_config"])
    s = train.seeds(seed)
    pool = tr.serve_pool(traffic, s["content"], dev)
    weights = serve.served_weights(a, config, dev)
    picked = serve.sample_requests(seed, {k: None for k in range(len(pool))}, pool, traffic["check_requests"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "control":
        served = {}
        for k in picked:
            enc, elens = rm.encode(a, weights, pool[k]["audio"].to(dev), pool[k]["audio_len"].to(dev), FP8)
            served[k] = rl.greedy_decode(a, weights, enc, elens, FP8)
    else:
        prog = serve.Program(config, weights, dev)
        served = {k: prog.serve(pool[k]) for k in picked}
        if mode == "token":
            served = {k: [alter(r, a.vocab) for r in rows] for k, rows in served.items()}
        del prog
        gc.collect()
        torch.cuda.empty_cache()
    gaps = [g for k in picked for g in serve.request_gaps(a, weights, pool[k], served[k])]
    tokens = sum(len(r) for k in picked for r in served[k])
    return {"served_gap": max(gaps), "tokens": tokens}


def alter(row: torch.Tensor, vocab: int) -> torch.Tensor:
    row = row.clone()
    if len(row):
        row[0] = row[0] % (vocab - 1) + 1  # another non-blank token
    return row


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True, choices=("program", "control", "half_batch", "token"))
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    workload = common.cell(args.workload)
    config, traffic = common.load("configs", workload["config"]), common.load("traffic", workload["traffic"])
    fn = train_seed if traffic["driver"] == "train" else serve_seed
    checks = train.CHECKS if traffic["driver"] == "train" else serve.CHECKS
    limits = common.load("limits", workload["name"])
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = fn(config, traffic, seed, args.mode, torch.device("cuda"))
        correct, _ = judge({k: got[k] for k in checks}, limits, 0)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed, "correct": correct, **got,
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
