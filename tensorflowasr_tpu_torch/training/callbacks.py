"""Training callbacks (counterpart of ``tensorflowasr_tpu/training/callbacks.py``).

``TerminateOnNaN``, ``EarlyStopping``, ``ModelCheckpoint`` (through
``Trainer.save``, which rotates), ``BackupAndRestore`` (restoring is
``Trainer.restore`` before ``fit``), ``TensorBoard`` (scalars as JSON
lines in ``log_dir/metrics.jsonl``: what the JAX package writes where
TensorFlow is absent; this module never imports TensorFlow) and
``PredictLogger`` (a TSV of predictions). ``deserialize`` builds the list
from reference-style config entries and skips unknown kinds with a warning.
``CheckNumerics`` is the command line's ``TFASR_CHECK_NUMERICS`` check
(``utils/env_util.setup_check_numerics``), not a config entry.

``TerminateOnNaN`` reads the loss on the host after every batch, which
waits for the card once a step.

Data-parallel (``parallel/sharding.py``): ``TensorBoard`` and
``PredictLogger`` write on rank 0 only (the rank at their construction),
and ``ModelCheckpoint`` saves through ``Trainer.save``, which does too.
``TerminateOnNaN`` and ``EarlyStopping`` decide alike on every rank: the
loss and the eval loss they read are the global ones.
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Optional

from tensorflowasr_tpu_torch.parallel.sharding import process_index
from tensorflowasr_tpu_torch.utils.file_util import preprocess_paths

logger = logging.getLogger("tensorflowasr_tpu_torch")


class Callback:
    stop_training = False

    def on_train_begin(self, trainer):
        pass

    def on_train_batch_end(self, trainer, state, metrics):
        pass

    def on_epoch_begin(self, trainer, epoch):
        pass

    def on_epoch_end(self, trainer, state, epoch, logs):
        pass

    def on_train_end(self, trainer, state):
        pass


class TerminateOnNaN(Callback):
    """Stops training after the batch whose loss is NaN or Inf."""

    def on_train_batch_end(self, trainer, state, metrics):
        loss = float(metrics["loss"])
        if math.isnan(loss) or math.isinf(loss):
            logger.error("NaN/Inf loss encountered — terminating training")
            self.stop_training = True


class CheckNumerics(Callback):
    """Raises ``FloatingPointError`` after a batch with a NaN or Inf metric."""

    def on_train_batch_end(self, trainer, state, metrics):
        bad = {k: float(v) for k, v in metrics.items() if not math.isfinite(float(v))}
        if bad:
            raise FloatingPointError(f"non-finite metrics at step {state.step}: {bad}")


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "val_loss", min_delta: float = 0.0, patience: int = 0, mode: str = "min", **_):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0

    def on_epoch_end(self, trainer, state, epoch, logs):
        value = logs.get(self.monitor)
        if value is None:
            return
        improved = (value < self.best - self.min_delta) if self.mode == "min" else (value > self.best + self.min_delta)
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                logger.info("EarlyStopping: no %s improvement for %d epochs", self.monitor, self.patience)
                self.stop_training = True


class ModelCheckpoint(Callback):
    """A checkpoint at each epoch's end (``Trainer.save`` keeps the newest ``keep_checkpoints``)."""

    def __init__(self, filepath: Optional[str] = None, **_):
        self.filepath = filepath

    def on_epoch_end(self, trainer, state, epoch, logs):
        trainer.save(state)


class BackupAndRestore(Callback):
    """Resume from the newest checkpoint: ``Trainer.restore`` runs before ``fit``."""

    def __init__(self, backup_dir: Optional[str] = None, **_):
        self.backup_dir = backup_dir


class TensorBoard(Callback):
    """Scalars as JSON lines (``{"step": ..., name: value}``) in ``log_dir/metrics.jsonl`` (rank 0 only)."""

    def __init__(self, log_dir: str = "logs", update_freq: int = 100, **_):
        chief = process_index() == 0
        self.log_dir = preprocess_paths(log_dir, isdir=True) if chief else os.path.abspath(os.path.expanduser(os.path.expandvars(log_dir)))
        self.update_freq = update_freq if isinstance(update_freq, int) else 100
        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a", encoding="utf-8") if chief else None

    def _log(self, step: int, metrics: dict):
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}) + "\n")
        self._jsonl.flush()

    def on_train_batch_end(self, trainer, state, metrics):
        if state.step % self.update_freq == 0:
            self._log(state.step, metrics)

    def on_epoch_end(self, trainer, state, epoch, logs):
        self._log(state.step, {f"epoch_{k}": v for k, v in logs.items() if v is not None})

    def on_train_end(self, trainer, state):
        self.close()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()


class PredictLogger(Callback):
    """Collects (path, groundtruth, greedy, beam) rows and writes a TSV (rank 0 only)."""

    def __init__(self, test_dataset=None, output: str = "predictions.tsv", **_):
        self.output = preprocess_paths(output) if process_index() == 0 else output
        self.rows: list[tuple] = []

    def add(self, path: str, groundtruth: str, greedy: str, beam: str = ""):
        self.rows.append((path, groundtruth, greedy, beam))

    def flush(self):
        if process_index() != 0:
            return
        with open(self.output, "w", encoding="utf-8") as f:
            f.write("PATH\tGROUNDTRUTH\tGREEDY\tBEAMSEARCH\n")
            for row in self.rows:
                f.write("\t".join(str(c) for c in row) + "\n")
        logger.info("Wrote %d predictions to %s", len(self.rows), self.output)


CALLBACKS = {
    "TerminateOnNaN": TerminateOnNaN,
    "EarlyStopping": EarlyStopping,
    "ModelCheckpoint": ModelCheckpoint,
    "BackupAndRestore": BackupAndRestore,
    "TensorBoard": TensorBoard,
    "PredictLogger": PredictLogger,
}


def deserialize(config_list: list) -> list[Callback]:
    """Callbacks from reference-style config entries; unknown kinds
    (e.g. KaggleModelBackupAndRestore) are skipped with a warning."""
    out = []
    for item in config_list or []:
        name = item.get("class_name", "").split(">")[-1]
        cfg = dict(item.get("config", {}))
        if name not in CALLBACKS:
            logger.warning("Skipping unsupported callback %r", name)
            continue
        try:
            out.append(CALLBACKS[name](**cfg))
        except TypeError:
            out.append(CALLBACKS[name]())
    return out
