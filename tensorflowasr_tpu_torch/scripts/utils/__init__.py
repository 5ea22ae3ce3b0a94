"""``utils`` subcommands (counterpart of ``tensorflowasr_tpu/scripts/utils/``):
``create_tfrecords``, ``create_datasets_metadata``, ``create_mls_trans``
and ``convert_checkpoint`` (a reference Keras ``.weights.h5`` → a port
checkpoint, a ``state_dict`` saved with ``torch.save``)."""

from __future__ import annotations

import logging
import os

import torch

from tensorflowasr_tpu_torch import pipeline
from tensorflowasr_tpu_torch.scripts import common

logger = logging.getLogger("tensorflowasr_tpu_torch")


def main(args):
    if args.util_command == "create_tfrecords":
        return create_tfrecords(args)
    if args.util_command == "create_datasets_metadata":
        return create_datasets_metadata(args)
    if args.util_command == "convert_checkpoint":
        return convert_checkpoint(args)
    if args.util_command == "create_mls_trans":
        from tensorflowasr_tpu_torch.scripts.utils.create_mls_trans import convert_split

        print(convert_split(args.split_dir, args.output))
        return 0
    raise SystemExit(f"unknown utils command {args.util_command}")


def create_tfrecords(args):
    """The TFRecord shards of the config's train, eval and test datasets
    that name a ``tfrecords_dir``, read as ``--dataset-type tfrecord``;
    another dataset type writes nothing, as in JAX."""
    config = common.load_config(args, training=True)
    tokenizer = pipeline.build_tokenizer(config)
    data = pipeline.build_datasets(config, tokenizer, args.dataset_type, stages=("train", "eval", "test"))
    written = 0
    for ds in [data["train"], data["eval"], *data["test"]]:
        if ds is not None and hasattr(ds, "create_tfrecords") and ds.tfrecords_dir:
            written += bool(ds.create_tfrecords())
    if not written:
        logger.warning("no TFRecord shards written (dataset type %r)", args.dataset_type)
    return 0


def create_datasets_metadata(args):
    """The tokenizer's vocabulary built when its file is missing, then the
    train (and eval) datasets' metadata saved (JAX
    ``scripts/utils/create_datasets_metadata``)."""
    from tensorflowasr_tpu_torch import tokenizers as tok_mod
    from tensorflowasr_tpu_torch.data import datasets as ds_mod

    config = common.load_config(args, training=True)
    tokenizer = tok_mod.get(config)
    train_cfg = config.data_config.train_dataset_config
    train_ds = ds_mod.get(tokenizer, train_cfg, args.dataset_type)
    try:
        tokenizer.make()
    except FileNotFoundError:
        logger.info("building tokenizer vocabulary ...")
        tokenizer.build(train_ds)
        tokenizer.make()
    if train_cfg.metadata:
        train_ds.save_metadata(train_cfg.metadata)
        eval_cfg = config.data_config.eval_dataset_config
        if eval_cfg.data_paths:
            ds_mod.get(tokenizer, eval_cfg, args.dataset_type).save_metadata(eval_cfg.metadata or train_cfg.metadata)
    return 0


def convert_checkpoint(args):
    """The config's model with the reference ``.weights.h5`` weights
    (``convert.keras_h5``) saved as a ``state_dict`` file that ``test``,
    ``save`` and ``export`` read through ``--checkpoint``, then reloaded."""
    from tensorflowasr_tpu_torch.convert import load_transducer_h5

    config = common.load_config(args, training=False)
    tokenizer = pipeline.build_tokenizer(config)
    model = common.build_model(config, tokenizer, args)
    state = load_transducer_h5(os.path.abspath(args.h5), model)
    output = os.path.abspath(args.output)
    os.makedirs(os.path.dirname(output), exist_ok=True)
    torch.save(state, output)
    model.load_state_dict(torch.load(output, map_location="cpu", weights_only=True), strict=True)
    logger.info("converted %s -> %s (%d arrays)", args.h5, output, len(state))
    return 0
