"""Data parallelism over processes, one card each (counterpart of
``tensorflowasr_tpu/parallel/sharding.py``).

JAX builds a 1-D ``data`` mesh over every device, shards the batch along
it and keeps the parameters replicated; XLA inserts the gradient
all-reduce (GSPMD). The port runs one process a card in one
``torch.distributed`` process group: :func:`init_process_group` joins it
(from ``torchrun``'s environment, or from an explicit rank, world size and
address), :func:`make_data_parallel_mesh` names it as a 1-D ``DeviceMesh``,
:func:`replicate` gives every rank rank 0's weights, and
``training/trainer.py`` reduces the gradients, the BatchNorm statistics
(:func:`sync_batch_norm`) and the loss's row count over it, so that a step
equals the one-device step on the global batch.

Each process feeds its own rows: the datasets take every ``world``-th
entry from ``rank`` (``data/datasets.py``), and :func:`shard_batch` only
moves them to the card. JAX pads a batch to its local device count with
zero-length rows, which then enter its BatchNorm statistics; one card a
process never pads (:func:`pad_batch_to_devices` with 1).

:func:`spawn` is the counterpart of JAX's ``env_util.cpu_offline_backend(n)``
(n virtual CPU devices in one process): it starts n processes that form
one group, gloo on the CPU, and returns what each returned.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.parallel.collectives import broadcast_, pmax
from tensorflowasr_tpu_torch.utils import device as device_util


def process_count() -> int:
    """Ranks in the process group (1 when none was formed)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 when no group was formed)."""
    return dist.get_rank() if dist.is_initialized() else 0


def init_process_group(device=None, backend: Optional[str] = None, rank: Optional[int] = None, world: Optional[int] = None,
                       init_method: Optional[str] = None) -> torch.device:
    """Joins the process group (once; later calls only return the device) and
    returns this process's device.

    ``rank``, ``world`` and ``init_method`` (e.g. ``tcp://localhost:PORT``)
    when given, else ``torchrun``'s ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR``/``MASTER_PORT`` (``env://``). ``device`` as
    ``utils.device.resolve`` takes it; a CUDA device without an index is the
    card ``LOCAL_RANK`` names (else the rank modulo the cards), made current.
    ``backend``: NCCL for a CUDA device and gloo for the CPU unless named
    (gloo on CUDA tensors puts two ranks on one card, which NCCL refuses);
    NCCL on the CPU raises."""
    if rank is None or world is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("no rank and world size given and no torchrun environment (RANK, WORLD_SIZE) to read them from")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = device_util.resolve(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, not {dev}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world)
    return dev


def make_data_parallel_mesh(device=None, axis_name: str = "data"):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over every rank of the group, of
    ``device``'s type (None: CUDA)."""
    from tensorflowasr_tpu_torch.utils.env_util import setup_mesh

    return setup_mesh((axis_name,), device=device)


def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Every rank of ``group`` takes the parameters and buffers of the group's first rank (in place)."""
    broadcast_([*module.parameters(), *module.buffers()], group)
    return module


def sync_batch_norm(module: torch.nn.Module, group) -> torch.nn.Module:
    """Every BatchNorm of ``module`` takes its batch statistics over the rows
    of all ranks of ``group`` (None: its own rows), as GSPMD computes them
    over the global batch."""
    from tensorflowasr_tpu_torch.models.layers.general import BatchNorm

    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module


def pad_batch_to_devices(batch: schemas.TrainData, n_devices: int) -> schemas.TrainData:
    """The batch with zero rows (zero lengths, which the masked-mean losses
    leave out) appended up to a multiple of ``n_devices``."""
    b = batch.inputs.inputs.shape[0]
    extra = -(-b // n_devices) * n_devices - b
    if not extra:
        return batch
    pad = lambda t: torch.cat([t, t.new_zeros((extra,) + tuple(t.shape[1:]))])
    return schemas.TrainData(schemas.TrainInput(*map(pad, batch.inputs)), schemas.TrainLabel(*map(pad, batch.labels)))


def shard_batch(batch: schemas.TrainData, device) -> schemas.TrainData:
    """This process's rows on its card: the process feeds its own share of the
    global batch, and one card a process pads nothing."""
    return pad_batch_to_devices(batch, 1).to(device)


def fingerprint(module: torch.nn.Module) -> torch.Tensor:
    """An int64 sum of the bits of every parameter and buffer (as f32 words):
    equal on two ranks that hold the same values, bit for bit."""
    tensors = [t.detach().float().contiguous() for t in (*module.parameters(), *module.buffers())]
    return torch.stack([t.view(torch.int32).to(torch.int64).sum() for t in tensors]).sum()


def check_replicated(module: torch.nn.Module, group=None) -> int:
    """Raises unless every rank of ``group`` holds the same parameters and
    buffers bit for bit; returns their :func:`fingerprint`."""
    fp = fingerprint(module)
    hi, lo = pmax(fp, group), -pmax(-fp, group)
    if hi.item() != lo.item():
        raise RuntimeError(f"the ranks' parameters differ: fingerprints from {lo.item()} to {hi.item()}")
    return int(fp.item())


# ----------------------------------- spawn ----------------------------------- #


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank: int, world: int, init_method: str, device, backend, fn, args, results) -> None:
    try:
        init_process_group(device, backend, rank, world, init_method)
        # pickled here, by value: a queue would hand CPU tensors over as shared memory, gone once this process ends
        results.put((rank, True, pickle.dumps(fn(*args))))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, device="cpu", backend: Optional[str] = None, timeout: float = 600.0) -> list:
    """``fn(*args)`` in each of ``n`` fresh processes that form one process
    group on ``device`` (``"cpu"``: gloo ranks; ``"cuda"``: the cards, NCCL
    unless ``backend`` names another), and their results in rank order.
    ``fn`` is pickled by name (a module-level function) and reads its rank
    from :func:`process_index`; results must pickle. A rank's exception, a
    rank that dies and the ``timeout`` raise here; every process is ended
    before this returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_spawned, args=(r, n, init_method, device, backend, fn, args, results), daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawned ranks {dead} died (exit codes {[procs[r].exitcode for r in dead]})") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawned ranks {sorted(set(range(n)) - set(out))} gave no result in {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"spawned rank {rank} of {n} failed:\n{value}")
            out[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=30.0 if len(out) == n else 0.1)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(n)]
