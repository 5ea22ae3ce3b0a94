"""Command line (counterpart of ``tensorflowasr_tpu/scripts/__init__.py``):
``python -m tensorflowasr_tpu_torch`` or the console script
``tensorflowasr_tpu_torch``, with the JAX package's subcommands, flags and
defaults: ``train``, ``test``, ``save``, ``export`` (and its alias
``tflite``), ``utils {create_tfrecords, create_datasets_metadata,
create_mls_trans, convert_checkpoint}``.

Where it differs: ``--device`` (default: the CUDA card; ``cpu`` runs the
kernels' plain versions) on every subcommand that reads a config; a
subcommand that builds a model raises without a card unless ``--device
cpu`` is given. ``--jit`` is accepted and does nothing (the port runs
eagerly). ``export --format`` takes ``pt2`` (the default, a
``torch.export`` program, where JAX has ``stablehlo``) or ``tflite``.
``convert_checkpoint`` writes a ``torch.save`` file where JAX writes an
orbax directory. ``--checkpoint`` (``test``, ``save``, ``export``) and
``{{modeldir}}/checkpoints`` take the port's checkpoints and the JAX
package's orbax directories alike (``convert/orbax.py``), as does
``learning_config.pretrained``. ``train`` runs data-parallel over N cards (or N gloo
ranks with ``--device cpu``) under ``python -m torch.distributed.run
--nproc_per_node N -m tensorflowasr_tpu_torch train ...``
(``scripts/train.py``).
"""

from __future__ import annotations

import argparse
import sys


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config-path", required=True, help="path to the .yml(.j2) config")
    p.add_argument("--datadir", default=None, help="value for the {{datadir}} config var")
    p.add_argument("--modeldir", default=None, help="value for the {{modeldir}} config var")
    p.add_argument("--dataset-type", default="slice", choices=["slice", "generator", "tfrecord"])
    p.add_argument("--jit", action="store_true", default=True, help="accepted for compatibility; the port runs eagerly")
    p.add_argument("--device", default=None, help="the device to run on (default: the CUDA card; 'cpu' runs the kernels' plain versions)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tensorflowasr_tpu_torch", description="ASR on CUDA cards (PyTorch port of tensorflowasr_tpu)")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train a model from config")
    _add_common(p_train)
    p_train.add_argument("--bs", type=int, default=None, help="batch size override")
    p_train.add_argument("--epochs", type=int, default=None)
    p_train.add_argument("--steps-per-epoch", type=int, default=None)
    p_train.add_argument("--mxp", default="strict", choices=["strict", "auto", "none"])
    p_train.add_argument("--profile", default=None, help="write a torch.profiler trace of 5 steps after one warm-up step to this dir, "
                         "with the program's spans (train.step and its phases, each kernel.*) collected into it")

    p_test = sub.add_parser("test", help="evaluate WER/CER on test datasets")
    _add_common(p_test)
    p_test.add_argument("--bs", type=int, default=1)
    p_test.add_argument("--beam-width", type=int, default=0)
    p_test.add_argument("--output", default="test_outputs.tsv")
    p_test.add_argument("--checkpoint", default=None)

    p_save = sub.add_parser("save", help="save final model params from a checkpoint")
    _add_common(p_save)
    p_save.add_argument("--output", required=True)
    p_save.add_argument("--checkpoint", default=None)

    for name in ("export", "tflite"):
        p_exp = sub.add_parser(name, help="export single-function inference artifact")
        _add_common(p_exp)
        p_exp.add_argument("--output", required=True)
        p_exp.add_argument("--format", default="pt2", choices=["pt2", "tflite"])
        p_exp.add_argument("--bs", type=int, default=1)
        p_exp.add_argument("--beam-width", type=int, default=0)
        p_exp.add_argument("--checkpoint", default=None)
        p_exp.add_argument("--streaming", action="store_true", help="export with carried state inputs (chunked inference)")

    p_utils = sub.add_parser("utils", help="dataset utilities")
    usub = p_utils.add_subparsers(dest="util_command", required=True)
    p_tfr = usub.add_parser("create_tfrecords")
    _add_common(p_tfr)
    p_meta = usub.add_parser("create_datasets_metadata")
    _add_common(p_meta)
    p_mls = usub.add_parser("create_mls_trans")
    p_mls.add_argument("--split-dir", required=True)
    p_mls.add_argument("--output", default=None)
    p_conv = usub.add_parser("convert_checkpoint", help="reference Keras .weights.h5 → port checkpoint (torch.save)")
    _add_common(p_conv)
    p_conv.add_argument("--h5", required=True, help="reference .h5/.weights.h5 checkpoint")
    p_conv.add_argument("--output", required=True, help="output file (a state_dict saved with torch.save)")
    return parser


MODEL_COMMANDS = ("train", "test", "save", "export", "tflite", "convert_checkpoint")


def main(argv=None):
    from tensorflowasr_tpu_torch.utils import env_util

    args = build_parser().parse_args(argv)
    env_util.setup_logging()
    if args.command in MODEL_COMMANDS or getattr(args, "util_command", None) in MODEL_COMMANDS:
        from tensorflowasr_tpu_torch.utils import device as device_util

        device_util.resolve(args.device)  # raises without a card unless --device cpu
    if args.command == "train":
        from tensorflowasr_tpu_torch.scripts import train as mod
    elif args.command == "test":
        from tensorflowasr_tpu_torch.scripts import test as mod
    elif args.command == "save":
        from tensorflowasr_tpu_torch.scripts import save as mod
    elif args.command in ("export", "tflite"):
        from tensorflowasr_tpu_torch.scripts import export as mod
    else:
        from tensorflowasr_tpu_torch.scripts import utils as mod
    return mod.main(args)


if __name__ == "__main__":
    sys.exit(main())
