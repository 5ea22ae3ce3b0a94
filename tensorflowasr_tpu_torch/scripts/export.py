"""``export`` / ``tflite`` subcommand (counterpart of
``tensorflowasr_tpu/scripts/export.py``): the raw-audio → transcript
inference program (``export.make_inference_fn``) at a 1 s signature
``[bs, 16000]``, with the streaming state among its inputs under
``--streaming``, saved as a ``torch.export`` program (``.pt2``), or through
``export.convert_tflite`` for ``--format tflite``. The model is built at
``mxp="none"``, as JAX builds it, so the program runs the f32 kernels.
"""

from __future__ import annotations

import torch

from tensorflowasr_tpu_torch import pipeline
from tensorflowasr_tpu_torch.scripts import common

NSAMPLES = 16000  # the 1 s signature; export again for another


def main(args):
    from tensorflowasr_tpu_torch import export as export_mod

    config = common.load_config(args, training=False)
    tokenizer = pipeline.build_tokenizer(config)
    model = common.load_weights(common.build_model(config, tokenizer, args, mxp="none"), args)
    device = next(model.parameters()).device

    fn = export_mod.make_inference_fn(model, tokenizer=tokenizer, beam_width=args.beam_width)
    example = [torch.zeros((args.bs, NSAMPLES), device=device), torch.full((args.bs,), NSAMPLES, dtype=torch.int32, device=device)]
    if args.streaming:
        prev_tokens = torch.zeros((args.bs,), dtype=torch.int64, device=device)
        dec_states = model.init_decoder_states(args.bs, device) if hasattr(model, "init_decoder_states") else None
        example += [prev_tokens, model.init_encoder_states(args.bs, device), dec_states]

    if args.format == "tflite":
        return 0 if export_mod.convert_tflite(fn, example, args.output) else 1
    export_mod.export_program(fn, example, args.output)
    return 0
