"""Which synthetic signal lets ``chip_smoke.py``'s overfit reach WER 0.

The smoke's overfit (:func:`chip_smoke.run_overfit`: a 2-block
Conformer-Transducer at the flagship's widths, dropout 0, four utterances
of 1–3 s, ``fit`` in rounds of 25 steps with ``evaluate_dataset`` after
each, a cap of 400 steps) is run here on one signal at one Adam learning
rate and prints one line: the steps it took to WER 0, or the WER and the
hypotheses at the cap. Two signals:

- ``stationary``: five harmonics of a wavering pitch under a
  syllable-rate envelope, with noise. Nothing in it depends on the
  transcript, so a model can tell the four utterances apart only by their
  lengths and their random pitch.
- ``voiced``: ``chip_smoke.data_audio``, where each character is a segment
  voiced with two tones of its own.

Run from the repository root, one process per case (they are independent):

    python3 scripts_torch/overfit_signals.py --signal stationary --lr 1e-3 --device cpu

On the CPU the model runs in f32 with the kernels' plain versions and no
time cap; on a CUDA card in bf16 through the kernels, with the smoke's
time cap.
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def stationary_audio(rng, n: int, text: str) -> np.ndarray:
    """A voiced-like signal that ignores ``text``: five harmonics of a wavering
    pitch under a syllable-rate envelope, with noise."""
    t = np.arange(n) / 16000
    f0 = rng.uniform(90, 250) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    voiced = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 6))
    env = 0.3 + 0.7 * np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t) ** 2
    return np.clip(0.12 * env * voiced + 0.02 * rng.standard_normal(n), -0.45, 0.45).astype(np.float32)


SIGNALS = {"stationary": stationary_audio, "voiced": cs.data_audio}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--signal", choices=sorted(SIGNALS), required=True)
    ap.add_argument("--lr", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    cpu = dev.type == "cpu"
    if not cpu:
        cs._no_tf32()
    from tensorflowasr_tpu_torch import pipeline

    with tempfile.TemporaryDirectory(prefix="tfasr-overfit-") as tmp:
        tok = pipeline.build_tokenizer(cs.data_config(tmp))
        manifest = cs.overfit_corpus(os.path.join(tmp, "overfit"), signal=SIGNALS[args.signal])
        what = f"signal {args.signal}, Adam {args.lr:g}, {dev.type} {'f32' if cpu else 'bf16'}"
        t0 = time.perf_counter()
        try:
            steps, _, report, _ = cs.run_overfit(dev, tok, manifest, dtype=torch.float32 if cpu else torch.bfloat16, lr=args.lr,
                                                 time_cap=float("inf") if cpu else cs.OVERFIT_TIME_CAP)
        except cs.OverfitCapReached as e:
            print(f"overfit ({what}): no WER 0 within the cap: WER {e.report['greedy']['wer']!r} after {e.steps} steps "
                  f"({time.perf_counter() - t0:.1f} s); hypotheses {[(r[1], r[2]) for r in e.report['rows']]}")
            return 0
        print(f"overfit ({what}): WER 0 after {steps} steps ({time.perf_counter() - t0:.1f} s); hypotheses {[r[2] for r in report['rows']]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
