"""ASR datasets: TSV manifests → padded batches of static shape (counterpart
of ``tensorflowasr_tpu/data/datasets.py``).

- manifests ``PATH\\tDURATION\\tTRANSCRIPT`` with a header line;
- per example: decode the audio (``data/audio.py``; FLAC through the
  native decoder), tokenize, prepend blank;
- metadata: the largest input (samples, from the durations) and label
  length, computed, saved to and loaded from JSON per stage, which fix the
  padded shapes (``get_global_shape``);
- ``create``: batches padded to those shapes, with ``drop_remainder`` and
  an indefinite repeat for training; the audio decoded in a thread pool
  that keeps the manifest's order, and the batches assembled by one
  producer thread a bounded ``prefetch`` ahead;
- ``ASRTFRecordDataset``: sharded GZIP TFRecords of WAV bytes
  (``data/tfrecord.py``).

Batches are ``schemas.TrainData`` of CPU tensors (audio f32, ids and
lengths int64), pinned when ``create(pin_memory=True)`` so that
``TrainData.to`` copies them to the card without blocking. ``rank`` and
``world`` give this process every ``world``-th entry (or TFRecord shard)
from ``rank``; metadata and vocabularies see every entry.
"""

from __future__ import annotations

import logging
import os
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.configs import Config, DatasetConfig
from tensorflowasr_tpu_torch.data import audio as audio_lib
from tensorflowasr_tpu_torch.data import tfrecord
from tensorflowasr_tpu_torch.utils import file_util

logger = logging.getLogger("tensorflowasr_tpu_torch")

BUFFER_SIZE = 100


def get(tokenizer, dataset_config: DatasetConfig, dataset_type: str = "slice", rank: int = 0, world: int = 1):
    """The dataset of ``dataset_config``: ``"tfrecord"`` or ``"slice"`` (audio files)."""
    if dataset_type == "tfrecord":
        return ASRTFRecordDataset(tokenizer=tokenizer, rank=rank, world=world, **vars(dataset_config))
    if dataset_type in ("slice", "generator", ""):
        return ASRSliceDataset(tokenizer=tokenizer, rank=rank, world=world, **vars(dataset_config))
    raise ValueError(f"dataset_type must be 'tfrecord' or 'slice', got {dataset_type}")


def _example(path: str, signal: np.ndarray, tokenizer, transcript: str) -> dict:
    labels = tokenizer.tokenize(transcript)
    predictions = tokenizer.prepand_blank(labels)
    return {
        "path": path,
        "transcript": transcript,
        "inputs": np.asarray(signal, np.float32),
        "inputs_length": np.int32(len(signal)),
        "labels": np.asarray(labels, np.int32),
        "labels_length": np.int32(len(labels)),
        "predictions": np.asarray(predictions, np.int32),
        "predictions_length": np.int32(len(predictions)),
    }


class ASRDataset:
    """Base dataset over TSV manifests."""

    def __init__(self, tokenizer, stage: str = "train", data_paths: Optional[list] = None, shuffle: bool = False, buffer_size: int = BUFFER_SIZE,
                 indefinite: bool = True, drop_remainder: bool = True, metadata: Optional[str] = None, sample_rate: int = 16000, name: str = "",
                 rank: int = 0, world: int = 1, **kwargs):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in [0, world {world})")
        self.tokenizer = tokenizer
        self.stage = stage
        self.data_paths = list(data_paths or [])
        self.shuffle = shuffle
        self.buffer_size = buffer_size
        self.indefinite = indefinite
        self.drop_remainder = drop_remainder
        self.metadata_path = metadata
        self.sample_rate = sample_rate
        self.name = name
        self.rank, self.world = rank, world
        self.entries: list[tuple[str, str, str]] = []
        self.num_entries = 0
        self.max_input_length = 0
        self.max_label_length = 0
        if metadata:
            self.load_metadata()

    # ------------------------------- entries -------------------------------- #

    def read_entries(self):
        if self.entries:
            return
        for path in self.data_paths:
            with open(file_util.preprocess_paths(path), "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
            for line in lines[1:]:  # the first line is the header PATH\tDURATION\tTRANSCRIPT
                if not line.strip():
                    continue
                parts = line.split("\t", 2)
                if len(parts) == 3:
                    self.entries.append(tuple(parts))
        if self.shuffle:
            random.shuffle(self.entries)
        self.num_entries = len(self.entries)
        logger.info("dataset %s: %d entries", self.name or self.stage, self.num_entries)

    def vocab_generator(self) -> Iterator[str]:
        for _, _, transcript in self.entries:
            yield transcript

    # ------------------------------- metadata ------------------------------- #

    def compute_metadata(self) -> dict:
        """The largest input in samples (from the durations) and label length
        (tokenizing every transcript), merged with what was loaded."""
        self.read_entries()
        for _, duration, transcript in self.entries:
            self.max_input_length = max(self.max_input_length, int(float(duration) * self.sample_rate))
            self.max_label_length = max(self.max_label_length, len(self.tokenizer.tokenize(transcript)))
        return {"max_input_length": self.max_input_length, "max_label_length": self.max_label_length, "num_entries": self.num_entries}

    def save_metadata(self, path: Optional[str] = None):
        path = file_util.preprocess_paths(path or self.metadata_path)
        content = file_util.load_json(path) if os.path.exists(path) else {}
        content[self.stage] = self.compute_metadata()
        file_util.save_json(path, content)

    def load_metadata(self, path: Optional[str] = None):
        path = file_util.preprocess_paths(path or self.metadata_path)
        if not path or not os.path.exists(path):
            return
        content = file_util.load_json(path).get(self.stage, {})
        self.max_input_length = content.get("max_input_length", 0)
        self.max_label_length = content.get("max_label_length", 0)
        self.num_entries = content.get("num_entries", self.num_entries)

    def update_metadata(self, path: Optional[str] = None):
        self.load_metadata(path)
        self.save_metadata(path)

    # -------------------------------- parsing ------------------------------- #

    def _load_audio(self, path: str) -> np.ndarray:
        return audio_lib.read_audio(path, sample_rate=self.sample_rate)

    def parse(self, path: str, transcript: str) -> dict:
        """One example: the decoded audio, its labels and the blank-prepended predictions (numpy)."""
        return _example(path, self._load_audio(path), self.tokenizer, transcript)

    def local_entries(self) -> list:
        """This process's entries: every ``world``-th from ``rank``."""
        local = list(self.entries)[self.rank::self.world]
        if not local and self.entries:
            raise RuntimeError(f"the dataset slice of rank {self.rank} of {self.world} is empty ({len(self.entries)} entries in all)")
        return local

    def examples(self, num_workers: int = 0) -> Iterator[dict]:
        """This process's examples in manifest order (shuffled per pass with
        ``shuffle``), repeated with ``indefinite``; with ``num_workers > 1``
        the audio is decoded in a thread pool ``4 × num_workers`` examples
        ahead. A dataset without entries yields nothing."""
        self.read_entries()
        while self.entries:
            entries = self.local_entries()
            if self.shuffle:
                random.shuffle(entries)
            if num_workers > 1:
                with ThreadPoolExecutor(max_workers=num_workers) as pool:
                    pending: deque = deque()
                    for path, _, transcript in entries:
                        pending.append(pool.submit(self.parse, path, transcript))
                        if len(pending) > num_workers * 4:
                            yield pending.popleft().result()
                    while pending:
                        yield pending.popleft().result()
            else:
                for path, _, transcript in entries:
                    yield self.parse(path, transcript)
            if not self.indefinite:
                return

    # ------------------------------- batching ------------------------------- #

    def create(self, batch_size: int, padded_input_length: Optional[int] = None, padded_label_length: Optional[int] = None, prefetch: int = 2,
               num_workers: int = 4, pin_memory: bool = False) -> Iterator[schemas.TrainData]:
        """Batches of ``batch_size`` padded to the given lengths (else the
        metadata's, else each batch's longest). ``prefetch > 0`` assembles
        them in a producer thread at most ``prefetch`` batches ahead; an
        error there is raised here, and closing the iterator stops it."""
        for batch, _ in self.labelled_batches(batch_size, padded_input_length, padded_label_length, prefetch, num_workers, pin_memory):
            yield batch

    def labelled_batches(self, batch_size: int, padded_input_length: Optional[int] = None, padded_label_length: Optional[int] = None,
                         prefetch: int = 2, num_workers: int = 4, pin_memory: bool = False) -> Iterator[tuple[schemas.TrainData, list]]:
        """:meth:`create`'s batches, each with its examples' ``(path, transcript)``
        (a TFRecord dataset's order is its shards', not the manifest's)."""
        in_len = padded_input_length or self.max_input_length or None
        lb_len = padded_label_length or self.max_label_length or None

        def batches():
            buf = []
            for ex in self.examples(num_workers=num_workers):
                buf.append(ex)
                if len(buf) == batch_size:
                    yield self._collate(buf, in_len, lb_len, pin_memory), [(e["path"], e["transcript"]) for e in buf]
                    buf = []
            if buf and not self.drop_remainder:
                yield self._collate(buf, in_len, lb_len, pin_memory), [(e["path"], e["transcript"]) for e in buf]

        yield from (_prefetched(batches(), prefetch) if prefetch > 0 else batches())

    @staticmethod
    def _collate(examples: list[dict], input_len: Optional[int], label_len: Optional[int], pin_memory: bool = False) -> schemas.TrainData:
        b = len(examples)
        in_len = input_len or max(len(e["inputs"]) for e in examples)
        lb_len = label_len or max(len(e["labels"]) for e in examples)
        inputs = np.zeros((b, in_len), np.float32)
        labels = np.zeros((b, lb_len), np.int64)
        predictions = np.zeros((b, lb_len + 1), np.int64)
        inputs_length, labels_length, predictions_length = (np.zeros((b,), np.int64) for _ in range(3))
        for i, e in enumerate(examples):
            n = min(len(e["inputs"]), in_len)
            inputs[i, :n] = e["inputs"][:n]
            inputs_length[i] = n
            u = min(len(e["labels"]), lb_len)
            labels[i, :u] = e["labels"][:u]
            labels_length[i] = u
            predictions[i, : u + 1] = e["predictions"][: u + 1]
            predictions_length[i] = u + 1
        tensor = (lambda a: torch.from_numpy(a).pin_memory()) if pin_memory else torch.from_numpy
        return schemas.TrainData(
            inputs=schemas.TrainInput(tensor(inputs), tensor(inputs_length), tensor(predictions), tensor(predictions_length)),
            labels=schemas.TrainLabel(tensor(labels), tensor(labels_length)),
        )


def _prefetched(items: Iterator, depth: int) -> Iterator:
    """``items`` produced by a daemon thread at most ``depth`` ahead; the
    producer's exception is raised in the consumer, and closing the
    consumer stops the producer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in items:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)
        finally:
            items.close()

    thread = threading.Thread(target=producer, daemon=True, name="tfasr-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=60)


class ASRSliceDataset(ASRDataset):
    """Reads the audio files the manifest names."""


class ASRTFRecordDataset(ASRDataset):
    """Sharded TFRecords of ``{path, audio (WAV bytes), transcript}`` examples."""

    def __init__(self, *args, tfrecords_dir: Optional[str] = None, tfrecords_shards: int = 16, compression: str = "GZIP", **kwargs):
        super().__init__(*args, **kwargs)
        self.tfrecords_dir = file_util.preprocess_paths(tfrecords_dir, isdir=True) if tfrecords_dir else None
        self.tfrecords_shards = tfrecords_shards
        self.compression = compression

    def _shard_path(self, shard_id: int) -> str:
        return os.path.join(self.tfrecords_dir, f"{self.stage}_{shard_id:02d}.tfrecord")

    def _have_shards(self) -> bool:
        return bool(self.tfrecords_dir) and any(os.path.exists(self._shard_path(i)) for i in range(self.tfrecords_shards))

    def create_tfrecords(self) -> bool:
        """Writes the entries round-robin into ``tfrecords_shards`` shards (nothing when a shard exists)."""
        if not self.tfrecords_dir:
            raise ValueError("tfrecords_dir is required")
        os.makedirs(self.tfrecords_dir, exist_ok=True)
        if self._have_shards():
            logger.info("tfrecords already exist in %s", self.tfrecords_dir)
            return True
        self.read_entries()
        if not self.num_entries:
            return False
        shards = [[] for _ in range(self.tfrecords_shards)]
        for i, (path, _, transcript) in enumerate(self.entries):
            shards[i % self.tfrecords_shards].append((path, transcript))
        for sid, items in enumerate(shards):
            records = (tfrecord.encode_example({"path": path, "audio": audio_lib.wav_bytes(self._load_audio(path), self.sample_rate),
                                                "transcript": transcript}) for path, transcript in items)
            n = tfrecord.write_records(self._shard_path(sid), records, compression=self.compression)
            logger.info("wrote %d examples to %s", n, self._shard_path(sid))
        return True

    def _decode(self, record: bytes) -> dict:
        ex = tfrecord.decode_example(record)
        signal, rate = audio_lib.read_wav_bytes(ex["audio"])
        if signal.ndim > 1:
            signal = signal.mean(axis=1)
        if rate != self.sample_rate:
            signal = audio_lib.resample(signal, rate, self.sample_rate)
        return _example(ex["path"].decode("utf-8"), signal, self.tokenizer, ex["transcript"].decode("utf-8"))

    def examples(self, num_workers: int = 0) -> Iterator[dict]:
        """The shards' examples (the manifest's audio files when there are no
        shards); with ``world > 1`` every ``world``-th shard from ``rank``,
        or every ``world``-th entry when there are fewer shards than ranks."""
        if not self._have_shards() or self.tfrecords_shards < self.world:
            yield from super().examples(num_workers=num_workers)
            return
        while True:
            shard_ids = list(range(self.tfrecords_shards))[self.rank::self.world]
            if self.shuffle:
                random.shuffle(shard_ids)
            for sid in shard_ids:
                if os.path.exists(self._shard_path(sid)):
                    for record in tfrecord.read_records(self._shard_path(sid), compression=self.compression):
                        yield self._decode(record)
            if not self.indefinite:
                return


def get_global_shape(config: Config, *datasets, batch_size: Optional[int] = None, num_devices: int = 1, num_local_devices: Optional[int] = None) -> dict:
    """Static shapes from the datasets' metadata: ``batch_size`` is per device
    (the learning config's by default), times ``num_devices`` globally and
    ``num_local_devices`` for this process's input pipeline."""
    per_device = batch_size or config.learning_config.batch_size
    return {
        "batch_size": per_device * num_devices,
        "local_batch_size": per_device * (num_local_devices or num_devices),
        "padded_input_length": max((d.max_input_length for d in datasets), default=0) or None,
        "padded_label_length": max((d.max_label_length for d in datasets), default=0) or None,
    }
