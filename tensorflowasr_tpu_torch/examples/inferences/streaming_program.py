"""Stream an audio file through a streaming inference program, block by
block, carrying the tokens and the encoder and decoder states between calls
(counterpart of ``examples/inferences/streaming_tflite_conformer.py``):
audio block *i* and states *i−1* in, the transcript so far and states *i*
out, read straight from the file as the JAX demo reads it.

The program is a ``.pt2`` written by ``python -m tensorflowasr_tpu_torch
export --streaming``: its inputs are the signal block [1, chunk], its
length [1], the previous tokens [1], the encoder states and the decoder
states; its outputs the transcript codepoints, the tokens, the next tokens
and the next states. The block length is the program's (``--blocksize``
must equal it when given); the states start at zero, read from the
program's own signature.

Usage:
  python -m tensorflowasr_tpu_torch.examples.inferences.streaming_program audio.flac \\
      --program conformer_streaming.pt2 [--blockstep N] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tensorflowasr_tpu_torch.examples.inferences.program import example_arguments


class StreamingProgramRecognizer:
    """Chunk loop around a streaming program (states carried)."""

    def __init__(self, path: str, device, blocksize: int | None = None):
        from tensorflowasr_tpu_torch import export as export_mod

        example = example_arguments(path, device)
        if len(example) != 5:
            raise ValueError(f"{path} is no streaming program ({len(example)} inputs; export it with --streaming)")
        self.blocksize = int(example[0].shape[1])
        if blocksize is not None and blocksize != self.blocksize:
            raise ValueError(f"the program takes blocks of {self.blocksize} samples, not {blocksize}")
        self.device = device
        self.fn = export_mod.load_program(path)
        self.length = torch.full_like(example[1], self.blocksize)
        self.carried = list(example[2:])  # previous tokens, encoder states, decoder states: zero

    def step(self, block: np.ndarray) -> str:
        from tensorflowasr_tpu_torch.export import codepoints_to_text

        if block.shape[0] < self.blocksize:
            block = np.pad(block, (0, self.blocksize - block.shape[0]))
        out = self.fn(torch.tensor(block[None, :], dtype=torch.float32, device=self.device), self.length, *self.carried)
        self.carried = [out.next_tokens, out.next_encoder_states, out.next_decoder_states]
        return codepoints_to_text(out.transcript[0].cpu().numpy())


def main(argv=None):
    p = argparse.ArgumentParser(prog="Conformer audio file streaming (exported program)")
    p.add_argument("filename", metavar="FILENAME", help="audio file to stream")
    p.add_argument("--program", type=str, required=True, help="path to the streaming .pt2 program")
    p.add_argument("-b", "--blocksize", type=int, default=None, help="samples per block (default: the program's)")
    p.add_argument(
        "--blockstep",
        type=int,
        default=None,
        help="advance per block; set to the frontend's chunk_step when the "
        "program's chunk windows overlap by the STFT frame tail "
        "(FrontendConfig.get_signal_chunk_size_and_step); default: blocksize",
    )
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--device", default=None, help="the device the program was exported on (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.blocksize is not None and args.blocksize <= 0:
        p.error("blocksize must be positive")

    from tensorflowasr_tpu_torch.data import audio as audio_lib
    from tensorflowasr_tpu_torch.utils import device as device_util

    rec = StreamingProgramRecognizer(args.program, device_util.resolve(args.device), args.blocksize)
    step = args.blockstep or rec.blocksize
    if step <= 0 or step > rec.blocksize:
        p.error("blockstep must be in (0, blocksize]")
    signal = np.asarray(audio_lib.read_audio(args.filename, sample_rate=args.sample_rate), np.float32)

    transcript = ""
    for start in range(0, signal.shape[0], step):
        transcript += rec.step(signal[start : start + rec.blocksize])
        print(transcript, flush=True)


if __name__ == "__main__":
    main()
