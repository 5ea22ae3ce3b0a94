"""Offline WER evaluation of a prediction TSV (counterpart of
``tensorflowasr_tpu/utils/app_util.py:evaluate_hypotheses``; its TFLite
conversion is ``export.convert_tflite``)."""

from __future__ import annotations

import logging

from tensorflowasr_tpu_torch.training.metrics import evaluate_hypotheses as _evaluate_pairs
from tensorflowasr_tpu_torch.utils import file_util

logger = logging.getLogger("tensorflowasr_tpu_torch")


def evaluate_hypotheses(filepath: str) -> dict:
    """Evaluate a prediction TSV (PATH, GROUNDTRUTH, GREEDY, BEAMSEARCH, a
    header line first): ``{"greedy": {wer, cer, mer, wil, wip}, ["beam":
    {...}]}``, the beam column over the rows that have a beam hypothesis."""
    path = file_util.preprocess_paths(filepath)
    greedy_pairs, beam_pairs = [], []
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    for line in lines[1:]:
        parts = line.split("\t")
        if len(parts) < 3:
            continue
        truth, greedy = parts[1], parts[2]
        beam = parts[3] if len(parts) > 3 else ""
        greedy_pairs.append((truth, greedy))
        if beam:
            beam_pairs.append((truth, beam))
    report = {"greedy": _evaluate_pairs(greedy_pairs)}
    if beam_pairs:
        report["beam"] = _evaluate_pairs(beam_pairs)
    for kind, metrics in report.items():
        logger.info("%s: %s", kind, {k: round(v, 6) for k, v in metrics.items()})
    return report
