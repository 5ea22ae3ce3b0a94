"""Recognition over a dataset with WER and CER (counterpart of
``tensorflowasr_tpu/training/evaluation.py``).

Greedy ``recognize`` over every batch of a dataset under
``torch.inference_mode()`` on the model's device (one fused decode launch
a batch for a transducer the kernel takes), and with ``beam_width`` > 0
beam search too (for a CTC model with the optional ``lm``), the tokens
detokenized on the host (blank padding through ``normalize_indices``) and
held against the normalized transcripts: WER over words and CER over
characters accumulated as text (``training/metrics.py``), per column, and
optionally the rows (path, truth, greedy, beam) for a ``PredictLogger``.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.models.ctc import base as ctc_base
from tensorflowasr_tpu_torch.models.transducer import base as transducer_base
from tensorflowasr_tpu_torch.training.callbacks import PredictLogger
from tensorflowasr_tpu_torch.training.metrics import ErrorRateAccumulator

logger = logging.getLogger("tensorflowasr_tpu_torch")


def evaluate_dataset(model: torch.nn.Module, dataset, tokenizer, batch_size: int = 1, beam_width: int = 0, collect_rows: bool = False,
                     num_workers: int = 4, predict_logger: Optional[PredictLogger] = None, lm=None) -> dict:
    """``{"greedy": {"wer", "cer"}, ["beam": {"wer", "cer"}], ["rows": [(path,
    truth, greedy, beam), ...]]}`` over one pass of ``dataset`` (an
    ``ASRDataset``; its ``indefinite`` and ``drop_remainder`` are turned
    off), ``batch_size`` utterances a ``recognize`` call, padded to the
    dataset's metadata lengths. ``beam_width`` > 0 adds the beam column
    (a CTC model's beam fuses ``lm``, an ``NGramLM``; a transducer's takes
    none, as in JAX); a row's beam is "" without it. Rows are also added
    to ``predict_logger``, which is then flushed."""
    is_transducer = isinstance(model, transducer_base.Transducer)
    recognize = transducer_base.recognize if is_transducer else ctc_base.recognize
    beam_kwargs = {"beam_width": beam_width} if is_transducer else {"beam_width": beam_width, "lm": lm}
    device = next(model.parameters()).device
    dataset.indefinite = False
    dataset.drop_remainder = False
    was_training = model.training
    model.eval()
    wacc, cacc = ErrorRateAccumulator(), ErrorRateAccumulator()
    wacc_b, cacc_b = ErrorRateAccumulator(), ErrorRateAccumulator()
    rows, i = [], 0
    try:
        for batch, entries in dataset.labelled_batches(batch_size, num_workers=num_workers, pin_memory=device.type == "cuda"):
            inputs = schemas.PredictInput(batch.inputs.inputs.to(device, non_blocking=True), batch.inputs.inputs_length.to(device, non_blocking=True))
            with torch.inference_mode():
                tokens = recognize(model, inputs).tokens.cpu().numpy()
                beam_tokens = recognize(model, inputs, **beam_kwargs).tokens.cpu().numpy() if beam_width else None
            for b, (path, transcript) in enumerate(entries):
                truth = tokenizer.normalize_text(transcript, tokenizer.decoder_config)
                greedy = tokenizer.detokenize(tokenizer.normalize_indices(tokens[b]))
                wacc.update(truth.split(), greedy.split())
                cacc.update(list(truth), list(greedy))
                beam = ""
                if beam_tokens is not None:
                    beam = tokenizer.detokenize(tokenizer.normalize_indices(beam_tokens[b]))
                    wacc_b.update(truth.split(), beam.split())
                    cacc_b.update(list(truth), list(beam))
                if collect_rows or predict_logger is not None:
                    rows.append((path, truth, greedy, beam))
                i += 1
    finally:
        model.train(was_training)
    report = {"greedy": {"wer": wacc.error_rate, "cer": cacc.error_rate}}
    if beam_width:
        report["beam"] = {"wer": wacc_b.error_rate, "cer": cacc_b.error_rate}
    if predict_logger is not None:
        for row in rows:
            predict_logger.add(*row)
        predict_logger.flush()
    if collect_rows:
        report["rows"] = rows
    logger.info("evaluated %d utterances: %s", i, {k: v for k, v in report.items() if k != "rows"})
    return report
