"""``train`` subcommand (counterpart of ``tensorflowasr_tpu/scripts/train.py``).

Config → tokenizer → datasets (static shapes from their metadata) → model
→ ``Trainer`` (the optimizer chain with accumulation, gradient and weight
noise; the config's callbacks) → ``fit``, with checkpoints and resume under
``{{modeldir}}/checkpoints`` and the warm start of ``learning_config.pretrained``.

On N cards, one process each, data-parallel (``parallel/sharding.py``):

    python -m torch.distributed.run --nproc_per_node N -m tensorflowasr_tpu_torch train ...

Under ``torchrun`` the process joins the group (NCCL; gloo with ``--device
cpu``) on the card ``LOCAL_RANK`` names, reads every ``world``-th entry of
the manifests from its rank, feeds ``batch_size`` rows a step of a global
batch of ``batch_size × world`` (JAX ``train.py:42-46``), and only rank 0
logs and writes checkpoints.
"""

from __future__ import annotations

import itertools
import logging
import os

import torch

from tensorflowasr_tpu_torch import pipeline
from tensorflowasr_tpu_torch.scripts import common
from tensorflowasr_tpu_torch.utils import tracing

logger = logging.getLogger("tensorflowasr_tpu_torch")

PROFILE_STEPS = 5
SEED = 42  # the weights' and the generators' seed (JAX: env_util.setup_seed(42))


def main(args):
    import torch.distributed as dist

    from tensorflowasr_tpu_torch import parallel

    if "WORLD_SIZE" in os.environ:  # torchrun
        args.device = str(parallel.init_process_group(args.device))
    try:
        return _train(args, parallel.process_index(), parallel.process_count())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, rank: int, world: int):
    from tensorflowasr_tpu_torch.data import datasets as ds_mod
    from tensorflowasr_tpu_torch.training import callbacks as cb_mod
    from tensorflowasr_tpu_torch.training.pretrained import warm_start
    from tensorflowasr_tpu_torch.training.trainer import Trainer
    from tensorflowasr_tpu_torch.utils import env_util

    if rank:
        logger.setLevel(logging.WARNING)
    env_util.setup_seed(SEED)
    check_numerics = env_util.setup_check_numerics()
    config = common.load_config(args, training=True)
    tokenizer = pipeline.build_tokenizer(config)
    model = common.build_model(config, tokenizer, args, mxp=args.mxp, seed=SEED)

    data = pipeline.build_datasets(config, tokenizer, args.dataset_type, stages=("train", "eval"), rank=rank, world=world)
    train_ds, eval_ds = data["train"], data["eval"]
    train_ds.load_metadata()
    if not train_ds.max_input_length:
        logger.info("computing dataset metadata (max lengths) ...")
        train_ds.compute_metadata()

    lc = config.learning_config
    shapes = ds_mod.get_global_shape(config, train_ds, batch_size=args.bs or lc.batch_size, num_devices=world, num_local_devices=1)
    logger.info("shapes: %s (%d processes, one device each)", shapes, world)

    callbacks = cb_mod.deserialize(lc.callbacks) + ([cb_mod.CheckNumerics()] if check_numerics else [])
    trainer = Trainer(model, lc.optimizer_config, device=args.device, ga_steps=lc.ga_steps, gradn_config=lc.gradn_config, gwn_config=lc.gwn_config,
                      checkpoint_dir=common.checkpoint_dir(), callbacks=callbacks)
    state = trainer.init_state(SEED)
    if lc.pretrained:
        # by name and shape (JAX scripts/train.py: Keras load_weights(by_name=True, skip_mismatch=True)); a resume checkpoint takes precedence below
        state = warm_start(state, lc.pretrained)
    state = trainer.restore(state)

    train_iter = train_ds.create(shapes["local_batch_size"], shapes["padded_input_length"], shapes["padded_label_length"])
    if getattr(args, "profile", None):
        sample = next(train_iter)
        train_iter = itertools.chain([sample], train_iter)  # the profiled batch is trained on too
        state, _ = trainer.train_step(state, sample)  # warm-up: builds the kernels and the allocator's blocks outside the trace
        activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if trainer.device.type == "cuda" else [])
        os.makedirs(args.profile, exist_ok=True)
        with tracing.collect() as spans, torch.profiler.profile(activities=activities) as prof:  # the trace names the program's phases and kernels
            for _ in range(PROFILE_STEPS):
                state, _ = trainer.train_step(state, sample)
        path = os.path.join(args.profile, "train_steps.trace.json")
        prof.export_chrome_trace(path)
        logger.info("wrote the profiler trace of %d steps (%d program spans) to %s", PROFILE_STEPS, len(spans), path)

    epochs = args.epochs or lc.num_epochs
    steps_per_epoch = args.steps_per_epoch or (train_ds.num_entries // shapes["batch_size"] if train_ds.num_entries else None)
    eval_iter = None
    if eval_ds is not None:
        eval_ds.load_metadata()
        eval_ds.indefinite = False
        eval_iter = list(eval_ds.create(shapes["local_batch_size"], shapes["padded_input_length"], shapes["padded_label_length"], prefetch=0))

    trainer.fit(state, train_iter, epochs=epochs, steps_per_epoch=steps_per_epoch, eval_data=eval_iter)
    return 0
