"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``benchmark/configs/<name>.json``) and a
traffic mix (``benchmark/traffic/<name>.json``, whose ``driver`` names the
module of ``benchmark/harness`` that drives it); its limits are in
``benchmark/limits/<cell>.json`` and each per-layer metric's reader in
``benchmark/metrics/<metric>.py``. The run sets up, warms up, measures for
``--seconds``, checks the window's outputs against the plain reference and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks`` (each
compared number beside its limit). Without the card the cell asks for it
exits 2; with a module of the JAX package loaded it exits 3; neither prints
a result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common  # noqa: E402

common.set_environment()


@dataclasses.dataclass
class Context:
    """What a driver needs of a run. ``plant`` receives the program's object
    after set-up builds it and returns what the run drives (the object itself;
    the fault tests return a broken one)."""

    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: object
    peaks: dict
    plant: object = lambda program: program
    parts: dict = dataclasses.field(default_factory=dict)

    def mark(self, part: str) -> None:
        """Set-up has finished ``part``: its seconds since the run's start, printed on standard error before the checks."""
        self.parts[part] = round(time.perf_counter() - self.t0, 4)


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", common.BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def judge(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """Whether a run is correct (nothing failed, every compared number finite and within its limit), and the checks: each
    compared number beside its limit. The numbers and the limits have to name the same checks."""
    if set(numbers) != set(limits):
        raise KeyError(f"the numbers compared {sorted(numbers)} and the limits {sorted(limits)} differ")
    checks = {n: {"value": float(v), "limit": float(limits[n])} for n, v in numbers.items()}
    return failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()), checks


def finish(ctx: Context, out: dict, numbers: dict, limits: dict) -> tuple[dict, dict]:
    """The result line's fields and the checks (each compared number beside its limit) from a driver's output."""
    bench = common.manifest()
    e2e = {m["name"]: m for m in bench["end_to_end"] if common.reports(m, ctx.workload, set())}
    if ctx.trace:
        out["record"]["peaks"] = ctx.peaks
        metrics = {}
        for m in bench["per_layer"]:
            if common.reports(m, ctx.workload, set(e2e)):
                v = metric_reader(m["name"])(out["record"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        missing = set(e2e) - set(out["e2e"])
        if missing:
            raise KeyError(f"the {ctx.traffic['driver']} driver measures no {sorted(missing)}")
        metrics = {n: {"value": out["e2e"][n], "unit": m["unit"]} for n, m in e2e.items()}
    correct, checks = judge(numbers, limits, out["failed"])
    device = dict(out["device"])
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        sub = out["record"]["sub"]
        device.update(busy_s=sub["busy_s"], window_s=sub["wall_s"])
        result["breakdown"] = {"device_ops": sub["device_ops"], "idle_gaps": sub["idle_gaps"]}
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    workload = common.cell(args.workload)
    config, traffic = common.load("configs", workload["config"]), common.load("traffic", workload["traffic"])
    import torch

    parts = {"torch": round(time.perf_counter() - T0, 4)}
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result", file=sys.stderr)
        return 2
    ctx = Context(workload, config, traffic, args.seed, args.seconds, bool(args.trace), T0, torch.device("cuda"),
                  common.peaks(torch.cuda.get_device_name(0)), parts=parts)
    ctx.mark("cuda_init")
    torch.ones(1, device=ctx.device).sum().item()  # the card's context, before any part that would otherwise pay for it
    ctx.mark("context")
    driver = importlib.import_module(f"benchmark.harness.{traffic['driver']}")
    out, numbers = driver.run(ctx)
    print("setup parts (seconds since the start at the end of each): " + json.dumps(ctx.parts), file=sys.stderr, flush=True)
    from tensorflowasr_tpu_torch.ops import routes

    print("routes taken (the kernel's, or the plain one where it refuses the shapes): "
          + json.dumps({f"{k}.{route}": n for (k, route), n in sorted(routes.counts.items())}), flush=True)
    bad = common.forbidden_loaded()
    if bad:
        print(f"modules of the JAX package are loaded: {bad}; no result", file=sys.stderr)
        return 3
    common.emit(*finish(ctx, out, numbers, common.load("limits", workload["name"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
