"""Error rates: WER and CER, with MER, WIL and WIP (counterpart of
``tensorflowasr_tpu/training/metrics.py``).

Host-side: a streaming accumulator of alignment counts (hits,
substitutions, deletions, insertions) from a Levenshtein alignment, the
error rate (S + D + I) / (H + S + D) and the offline report's MER, WIL and
WIP from the same counts. ``ops/edit_distance.py`` computes the distances
on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


def _align_counts(ref: Sequence, hyp: Sequence) -> tuple[int, int, int, int]:
    """Levenshtein alignment → (hits, substitutions, deletions, insertions)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, hits, subs, dels, ins)
    prev = [(j, 0, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, 0, i, 0)] + [None] * m
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                c, h, s, d, ins = prev[j - 1]
                cur[j] = (c, h + 1, s, d, ins)
            else:
                sub = prev[j - 1]
                dele = prev[j]
                insr = cur[j - 1]
                best = min((sub[0], 0, sub), (dele[0], 1, dele), (insr[0], 2, insr), key=lambda t: (t[0], t[1]))
                c, h, s, d, ins = best[2]
                kind = best[1]
                cur[j] = (c + 1, h, s + (kind == 0), d + (kind == 1), ins + (kind == 2))
        prev = cur
    _, h, s, d, ins = prev[m]
    return h, s, d, ins


@dataclasses.dataclass
class ErrorRateAccumulator:
    """Streaming numerator/denominator accumulation (reference parity)."""

    hits: int = 0
    substitutions: int = 0
    deletions: int = 0
    insertions: int = 0

    def update(self, reference: Sequence, hypothesis: Sequence):
        h, s, d, i = _align_counts(list(reference), list(hypothesis))
        self.hits += h
        self.substitutions += s
        self.deletions += d
        self.insertions += i

    @property
    def error_rate(self) -> float:
        denom = self.hits + self.substitutions + self.deletions
        if denom == 0:
            return 0.0
        return (self.substitutions + self.deletions + self.insertions) / denom

    @property
    def mer(self) -> float:
        denom = self.hits + self.substitutions + self.deletions + self.insertions
        return 0.0 if denom == 0 else (self.substitutions + self.deletions + self.insertions) / denom

    @property
    def wip(self) -> float:
        n_ref = self.hits + self.substitutions + self.deletions
        n_hyp = self.hits + self.substitutions + self.insertions
        if n_ref == 0 or n_hyp == 0:
            return 0.0
        return (self.hits / n_ref) * (self.hits / n_hyp)

    @property
    def wil(self) -> float:
        return 1.0 - self.wip


def wer(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    acc = ErrorRateAccumulator()
    for r, h in zip(references, hypotheses):
        acc.update(r.split(), h.split())
    return acc.error_rate


def cer(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    acc = ErrorRateAccumulator()
    for r, h in zip(references, hypotheses):
        acc.update(list(r), list(h))
    return acc.error_rate


def evaluate_hypotheses(pairs: Sequence[tuple[str, str]]) -> dict:
    """(ref, hyp) pairs → {wer, cer, mer, wil, wip} (app_util.py:27-82 parity)."""
    wacc, cacc = ErrorRateAccumulator(), ErrorRateAccumulator()
    for ref, hyp in pairs:
        wacc.update(ref.split(), hyp.split())
        cacc.update(list(ref), list(hyp))
    return {
        "wer": wacc.error_rate,
        "cer": cacc.error_rate,
        "mer": wacc.mer,
        "wil": wacc.wil,
        "wip": wacc.wip,
    }
