"""``test`` subcommand (counterpart of ``tensorflowasr_tpu/scripts/test.py``).

Loads the weights (``--checkpoint``, else the newest checkpoint in
``{{modeldir}}/checkpoints``, else the seed's initialisation), runs greedy
and, with a beam width (``--beam-width``, else the decoder config's), beam
recognition over each test dataset, writes the prediction TSV and logs the
WER/CER/MER/WIL/WIP report.
"""

from __future__ import annotations

from tensorflowasr_tpu_torch import pipeline
from tensorflowasr_tpu_torch.scripts import common


def main(args):
    from tensorflowasr_tpu_torch.training.callbacks import PredictLogger
    from tensorflowasr_tpu_torch.training.evaluation import evaluate_dataset
    from tensorflowasr_tpu_torch.utils import app_util

    config = common.load_config(args, training=False)
    tokenizer = pipeline.build_tokenizer(config)
    model = common.load_weights(common.build_model(config, tokenizer, args), args)

    # JAX's predict step always makes the greedy and the beam columns; the beam width comes from the decoder config unless set here
    beam_width = args.beam_width or int(getattr(config.decoder_config, "beam_width", 0) or 0)
    for ds in pipeline.build_datasets(config, tokenizer, args.dataset_type, stages=("test",))["test"]:
        evaluate_dataset(model, ds, tokenizer, batch_size=args.bs, beam_width=beam_width, predict_logger=PredictLogger(output=args.output))
        app_util.evaluate_hypotheses(args.output)
    return 0
