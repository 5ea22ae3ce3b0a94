"""Single-file recognition (counterpart of ``examples/inferences/main.py``).

Usage:
  python -m tensorflowasr_tpu_torch.examples.inferences.main --config-path CONFIG --audio FILE \\
      [--checkpoint CKPT] [--beam-width N] [--device cpu]

``--checkpoint`` takes the port's checkpoints and the JAX package's orbax
directories (a ``save`` artifact, a ``Trainer`` directory or step); without
it the newest checkpoint under ``{{modeldir}}/checkpoints`` is read, else
the model keeps its initialisation. Runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-path", required=True)
    p.add_argument("--audio", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--beam-width", type=int, default=0)
    p.add_argument("--datadir", default=None)
    p.add_argument("--modeldir", default=None)
    p.add_argument("--device", default=None, help="the device to run on (default: the CUDA card)")
    args = p.parse_args(argv)

    from tensorflowasr_tpu_torch import pipeline, schemas
    from tensorflowasr_tpu_torch.data import audio as audio_lib
    from tensorflowasr_tpu_torch.models.ctc import base as ctc_base
    from tensorflowasr_tpu_torch.models.transducer import base as transducer_base
    from tensorflowasr_tpu_torch.scripts import common

    config = common.load_config(args, training=False)
    tokenizer = pipeline.build_tokenizer(config)
    model = common.load_weights(common.build_model(config, tokenizer, args), args)
    device = next(model.parameters()).device

    signal = np.asarray(audio_lib.read_audio(args.audio, sample_rate=16000), np.float32)
    signals = torch.tensor(signal[None, :], device=device)
    lengths = torch.tensor([len(signal)], dtype=torch.int64, device=device)

    rec = transducer_base.recognize if isinstance(model, transducer_base.Transducer) else ctc_base.recognize
    out = rec(model, schemas.PredictInput(inputs=signals, inputs_length=lengths), beam_width=args.beam_width)
    print(tokenizer.detokenize(out.tokens[0].cpu().numpy()))


if __name__ == "__main__":
    main()
