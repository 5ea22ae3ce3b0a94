"""Transducer single-file recognition, whole or in chunks that carry the
encoder and prediction states (counterpart of
``examples/inferences/rnn_transducer.py``): build the model from a
transducer config, read its checkpoint (the port's or the JAX package's
orbax directory), and decode the utterance at once or chunk by chunk
through ``recognize``'s streaming contract (``PredictInput.previous_*`` →
``PredictOutput.next_*``).

Usage:
  python -m tensorflowasr_tpu_torch.examples.inferences.rnn_transducer --config-path \\
      examples/models/transducer/rnnt/small.yml.j2 --audio x.flac \\
      [--checkpoint CKPT] [--beam-width N] [--chunk-secs 1.0] [--device cpu]
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
    p.add_argument("--chunk-secs", type=float, default=0.0, help="> 0 enables chunked streaming decode")
    p.add_argument("--datadir", default=None)
    p.add_argument("--modeldir", default=None)
    p.add_argument("--device", default=None, help="the device to run on (default: the CUDA card)")
    args = p.parse_args(argv)

    from tensorflowasr_tpu_torch import pipeline, schemas
    from tensorflowasr_tpu_torch.data import audio as audio_lib
    from tensorflowasr_tpu_torch.models.transducer import base as transducer_base
    from tensorflowasr_tpu_torch.scripts import common

    config = common.load_config(args, training=False)
    tokenizer = pipeline.build_tokenizer(config)
    model = common.load_weights(common.build_model(config, tokenizer, args), args)
    device = next(model.parameters()).device

    sr = config.speech_config.get("sample_rate", 16000) if hasattr(config, "speech_config") else 16000
    signal = np.asarray(audio_lib.read_audio(args.audio, sample_rate=sr), np.float32)

    def rec(seg: np.ndarray, n: int, **previous):
        pin = schemas.PredictInput(inputs=torch.tensor(seg[None, :], device=device), inputs_length=torch.tensor([n], dtype=torch.int64, device=device),
                                   **previous)
        return transducer_base.recognize(model, pin, beam_width=args.beam_width)

    if args.chunk_secs <= 0:
        out = rec(signal, len(signal))
        print(tokenizer.detokenize(out.tokens[0].cpu().numpy()))
        return

    # chunked streaming: fixed-size chunks (zero-padded tail), states carried
    chunk = int(args.chunk_secs * sr)
    prev_tokens = None
    enc_states = model.init_encoder_states(1, device)
    dec_states = None
    pieces = []
    for lo in range(0, len(signal), chunk):
        seg = signal[lo : lo + chunk]
        n = len(seg)
        if n < chunk:
            seg = np.pad(seg, (0, chunk - n))
        out = rec(seg, n, previous_tokens=prev_tokens, previous_encoder_states=enc_states, previous_decoder_states=dec_states)
        prev_tokens = out.next_tokens
        enc_states = out.next_encoder_states
        dec_states = out.next_decoder_states
        pieces.append(tokenizer.detokenize(out.tokens[0].cpu().numpy()))
    print("".join(pieces) if getattr(tokenizer.decoder_config, "keep_whitespace", False) else " ".join(x for x in pieces if x))


if __name__ == "__main__":
    main()
