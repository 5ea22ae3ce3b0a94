"""Data and tensor parallelism across processes (counterpart of ``tensorflowasr_tpu/parallel/``)."""

from tensorflowasr_tpu_torch.parallel.collectives import psum, psum_replicated
from tensorflowasr_tpu_torch.parallel.sharding import (init_process_group, make_data_parallel_mesh, process_count, process_index, replicate,
                                                       shard_batch, spawn)
