"""Run an exported inference program on one audio file (counterpart of
``examples/inferences/tflite.py``): load the ``.pt2`` that ``python -m
tensorflowasr_tpu_torch export`` writes, feed raw audio (zero-padded to the
program's fixed signal length) with zero initial streaming states where the
program takes them, and print the tokens, the next tokens and the
transcript, as the JAX demo does for its artifact.

Usage:
  python -m tensorflowasr_tpu_torch.examples.inferences.program --artifact model.pt2 --audio x.flac [--device cpu]

A program runs on the device it was exported on (``export --device``):
pass the same ``--device`` here (default: the CUDA card).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def example_arguments(path: str, device) -> tuple:
    """Zero-filled arguments of the signature of the program at ``path``, in its input structure."""
    from tensorflowasr_tpu_torch.ops.cuda import library  # noqa: F401  (registers the operators the program names)

    program = torch.export.load(path)
    nodes = {n.name: n for n in program.graph.nodes if n.op == "placeholder"}
    vals = [None if name is None else nodes[name].meta["val"] for name in program.graph_signature.user_inputs]  # None: an input traced as None
    leaves = [None if v is None else torch.zeros(v.shape, dtype=v.dtype, device=device) for v in vals]
    args, _ = torch.utils._pytree.tree_unflatten(leaves, program.call_spec.in_spec)
    return tuple(args)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--artifact", required=True, help=".pt2 written by `python -m tensorflowasr_tpu_torch export`")
    p.add_argument("--audio", required=True)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--device", default=None, help="the device the program was exported on (default: the CUDA card)")
    args = p.parse_args(argv)

    from tensorflowasr_tpu_torch import export as export_mod
    from tensorflowasr_tpu_torch.data import audio as audio_lib
    from tensorflowasr_tpu_torch.utils import device as device_util

    device = device_util.resolve(args.device)
    example = example_arguments(args.artifact, device)
    n = example[0].shape[1]
    signal = np.asarray(audio_lib.read_audio(args.audio, sample_rate=args.sample_rate), np.float32)
    if len(signal) > n:
        p.error(f"the program takes {n} samples and the audio has {len(signal)}: export a longer signature, or stream it with "
                "tensorflowasr_tpu_torch.examples.inferences.streaming_program")
    signals = torch.zeros_like(example[0])
    signals[:, : len(signal)] = torch.tensor(signal, device=device)
    lengths = torch.full_like(example[1], len(signal))

    out = export_mod.load_program(args.artifact)(signals, lengths, *example[2:])
    print("next_tokens:", out.next_tokens.cpu().numpy())
    print("tokens:", out.tokens[0].cpu().numpy()[:32], "...")
    print("transcript:", export_mod.codepoints_to_text(out.transcript[0].cpu().numpy()))


if __name__ == "__main__":
    main()
