"""Serving cells: batch transcription through ``recognize`` (greedy WIND,
the fused decode), one client in a closed loop.

Set-up builds the model, loads the configuration's served model
(:func:`served_weights`), makes the pool of
requests in pinned host memory (each padded to its own longest utterance)
and serves the longest request once (the warm-up: the largest shape, so
the allocator holds blocks for every smaller one). The window then issues
requests back to back, cycling the pool; each request's latency runs from
issue (audio in host memory) to its tokens back in host memory.

The check, once the window has closed and the program's state is freed: a
sample of the finished requests drawn from the seed, the one with the
longest utterance among them, is transcribed again by the reference in
float32 along the tokens the program served, and the largest gap by which a
served decision's logit lies below the reference's best is compared
(``reference/loss.py:served_gap``).
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from ..reference import loss as rl
from ..reference import model as rm
from . import common, flops, trace
from . import traffic as tr
from .train import _sync, build_program, load_weights, seeds

KIND = "serve"  # the kind of the record a traced run hands to the metric readers
CHECKS = ("served_gap",)  # the numbers compared, each with its limit in benchmark/limits/<cell>.json
MEASURES = ("serve_audio_s_per_s", "serve_p95_ms", "setup_s")  # the end-to-end metrics a run measures
# A traced run's record, with every field this driver writes (the readers' tests read it).
EXAMPLE_RECORD = {"kind": KIND, "window_s": 20.0, "requests": 260, "flops": 2.9e14, "tokens_per_audio_s": 4.0,
                  "sub": {"wall_s": 0.6, "busy_s": 0.34, "ops": 10384, "n": 8, "least_s": 0.006, "device_ops": [], "idle_gaps": []}}
PROFILED_REQUESTS = 8


class Program:
    """The program's serving object: the model in inference mode and the call that serves one request."""

    def __init__(self, config: dict, weights: dict, device):
        self.model = build_program(config, device)
        load_weights(self.model, weights)
        self.model.eval()
        self.device = device

    def serve(self, item: dict) -> list:
        """One request: the audio to the card, ``recognize``, the tokens to host memory; the token rows."""
        from tensorflowasr_tpu_torch import schemas
        from tensorflowasr_tpu_torch.models.transducer.base import recognize

        audio = item["audio"].to(self.device, non_blocking=True)
        lens = item["audio_len"].to(self.device, non_blocking=True)
        tokens = recognize(self.model, schemas.PredictInput(audio, lens)).tokens.cpu()
        return [row[row != self.model.blank] for row in tokens]


def token_budget(samples: list, a: rm.Arch) -> int:
    """The decoder's token limit of a request: 2 × its padded encoder frames + 1."""
    return 2 * flops.encoder_frames(a, max(samples)) + 1


@torch.no_grad()
def request_gaps(a: rm.Arch, w: dict, item: dict, rows: list, q: rm.Operands = rm.F32) -> list:
    """The reference's gap (``served_gap``) of each utterance's served tokens ``rows``, the request encoded as the program encoded it."""
    dev = next(iter(w.values())).device
    enc, elens = rm.encode(a, w, item["audio"].to(dev), item["audio_len"].to(dev), q)
    budget = token_budget(item["samples"], a)
    out = []
    for b, tokens in enumerate(rows):
        tokens = tokens.to(dev)
        t = int(elens[b])
        pred = rm.predict(a, w, torch.cat([torch.full((1,), a.blank, device=dev, dtype=torch.long), tokens.long()])[None], None, q)
        logits = rm.joint_logits(w, rm.project_encoder(w, enc[b, :t], q)[:, None], rm.project_prediction(w, pred[0], q)[None], q)
        out.append(rl.served_gap(logits, tokens, t, budget, a.blank))
    return out


def served_weights(a: rm.Arch, config: dict, device, blank_bias: float | None = None) -> dict:
    """The configuration's served model: its weights made from ``serve_model.weights_seed``, the blank logit's bias
    ``serve_model.blank_bias`` (or ``blank_bias``), and the blank row of the joint's vocabulary weight drawn (from the
    weight seed + 1) at ``serve_model.blank_row_scale`` times the lecun scale. A deployment serves one model, so the served
    model is the configuration's and the run's seed draws the traffic. A random joint emits a token where a frame's best
    non-blank logit beats the blank's; with a constant blank logit that happens at almost every frame or at almost none (the
    best of 1,023 random logits lies in a narrow band), so the rate fell from the 2T + 1 budget to none within a few tenths
    of the bias. A drawn blank row spreads the blank logit over frames, so the rate falls smoothly with the bias."""
    m = config["serve_model"]
    w = rm.make_weights(a, m["weights_seed"], m["blank_bias"] if blank_bias is None else blank_bias, device)
    j = w["joint.vocab.weight"].shape[1]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(m["weights_seed"]) + 1)
    w["joint.vocab.weight"][a.blank] = torch.randn(j, generator=gen, device=device) * (m["blank_row_scale"] / math.sqrt(j))
    return w


def p95(latencies: list) -> float:
    """The 95th percentile of every latency (inclusive quantiles; one latency is its own)."""
    return latencies[0] if len(latencies) == 1 else statistics.quantiles(latencies, n=20, method="inclusive")[18]


def sample_requests(seed: int, served: dict, pool: list, n: int) -> list:
    """``n`` finished requests drawn from the seed, the one holding the longest utterance among them."""
    done = sorted(served)
    longest = max(done, key=lambda k: max(pool[k]["samples"]))
    rest = [k for k in done if k != longest]
    rng = np.random.default_rng(int(seed) + 7)
    return [longest] + [rest[i] for i in rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)]


def run(ctx) -> tuple[dict, dict]:
    a = rm.arch_of(ctx.config["model_config"])
    s = seeds(ctx.seed)
    dev = ctx.device
    pool = tr.serve_pool(ctx.traffic, s["content"], dev)
    ctx.mark("pool")
    weights = served_weights(a, ctx.config, dev)
    ctx.mark("weights")
    prog = ctx.plant(Program(ctx.config, weights, dev))
    ctx.mark("model")
    work = [(sum(it["samples"]) / ctx.traffic["sample_rate"], flops.serve_request_bytes(a, len(it["samples"]), it["audio"].shape[1])) for it in pool]
    prog.serve(max(pool, key=lambda it: it["audio"].shape[1]))
    ctx.mark("warm_up")
    gc.collect()
    gc.freeze()
    _sync(dev)
    start = time.perf_counter()
    setup_s = start - ctx.t0
    served, latencies, flop, audio_s, failed, n = {}, [], 0.0, 0.0, 0, 0
    while time.perf_counter() - start < ctx.seconds:
        k = n % len(pool)
        n += 1
        t_issue = time.perf_counter()
        try:
            rows = prog.serve(pool[k])
        except Exception:  # a request that raises is a failed request; the loop serves on
            failed += 1
            print(f"request {n - 1} failed:", file=sys.stderr)
            traceback.print_exc()
            latencies.append(time.perf_counter() - t_issue)
            continue
        latencies.append(time.perf_counter() - t_issue)
        served[k] = rows
        audio_s += work[k][0]
        flop += sum(flops.serve_utterance_flops(a, m, len(r)) for m, r in zip(pool[k]["samples"], rows))
    wall = time.perf_counter() - start
    token_rate = sum(len(r) for k in served for r in served[k]) / max(sum(work[k][0] for k in served), 1e-9)
    print(f"tokens served per audio second (the decode's work): {token_rate!r}", file=sys.stderr)
    record = {"kind": KIND, "window_s": wall, "requests": n, "flops": flop, "tokens_per_audio_s": token_rate}
    if ctx.trace:
        order = [(n + j) % len(pool) for j in range(PROFILED_REQUESTS)]
        record["sub"] = trace.profile(torch, lambda j: prog.serve(pool[order[j]]), PROFILED_REQUESTS)
        record["sub"]["least_s"] = 0.0
        for k in order:
            rows = served.get(k) or prog.serve(pool[k])
            f = sum(flops.serve_utterance_flops(a, m, len(r)) for m, r in zip(pool[k]["samples"], rows))
            record["sub"]["least_s"] += max(f / ctx.peaks["flops"], work[k][1] / ctx.peaks["bytes"])
    device = common.device_record(torch, 1)
    del prog
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    e2e = {"serve_audio_s_per_s": audio_s / wall, "serve_p95_ms": 1e3 * p95(latencies), "setup_s": setup_s}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gaps = [math.inf]  # no finished request: nothing served is correct
    if served:
        gaps = [g for k in sample_requests(ctx.seed, served, pool, ctx.traffic["check_requests"]) for g in request_gaps(a, weights, pool[k], served[k])]
    return {"attempted": n, "failed": failed, "e2e": e2e, "record": record, "device": device}, {"served_gap": max(gaps)}
