"""The multi-process glue (counterpart of
``spatialthinker_tpu/parallel/multihost.py``): one process per GPU, launched
by ``torchrun`` (or any launcher that sets ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``), every rank running the same trainer on its own rows.

``initialize_if_needed`` brings the process group up; the rest moves host
data between ranks. Unlike the JAX function, ``initialize_if_needed`` lets
every error through: a group that fails to come up raises.

The JAX module assembles global arrays from process-local data because XLA
runs one program over every device. Here a process owns one device and holds
its own rows as plain tensors, so of those functions:

- ``global_batch_array`` (local rows -> global array) is the identity: a
  rank's tensor IS its slice of the batch;
- ``host_local_rows`` (global array -> this host's rows) is the identity too;
- ``global_array_from_full`` (a full host value every process holds -> the
  global array) is a row slice: ``full[slice(*process_local_slice(len(full)))]``;
- ``fetch_global`` (global array -> the full value on every process) is the
  all-gather of each rank's rows: ``allgather_host_data``, under both names.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch.distributed as dist


def launched() -> bool:
    """True when a launcher started this process as one rank of several."""
    return "WORLD_SIZE" in os.environ


def initialize_if_needed(device_type: str, *, init_method: Optional[str] = None,
                         world_size: Optional[int] = None, rank: Optional[int] = None,
                         force: bool = False) -> bool:
    """Bring the default process group up when a launcher set ``WORLD_SIZE``,
    when ``world_size`` is given, or when ``force`` asks for it
    (``trainer.nnodes`` > 1); returns whether a group exists. NCCL on the
    card, gloo on the CPU. Errors propagate."""
    if dist.is_initialized():
        return True
    if not (force or launched() or world_size is not None):
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    kwargs = {}
    if world_size is not None:
        kwargs.update(world_size=world_size, rank=rank)
    dist.init_process_group(backend=backend, init_method=init_method or "env://", **kwargs)
    return True


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def process_local_slice(global_size: int, group=None) -> Tuple[int, int]:
    """[start, end) of this rank's rows of a batch split over ``group``."""
    n = world_size(group)
    if global_size % n:
        raise ValueError(f"global batch {global_size} not divisible by {n} processes")
    per = global_size // n
    i = rank(group)
    return i * per, (i + 1) * per


def allgather_pyobj(obj, group=None) -> List:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    if world_size(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def allgather_host_data(local: np.ndarray, group=None) -> np.ndarray:
    """Every rank's rows (numpy, axis 0), concatenated in rank order on
    every rank; the row counts may differ."""
    if world_size(group) == 1:
        return np.asarray(local)
    return np.concatenate([np.asarray(x) for x in allgather_pyobj(np.asarray(local), group)], axis=0)


def negotiate_row_count(local_rows: int, group=None) -> int:
    """A common row count (the max over ranks) for stages whose local counts
    depend on the data, e.g. FFD packing: ranks pad up to it, padding rows
    carrying segment id 0."""
    return max(int(x) for x in allgather_pyobj(int(local_rows), group))


fetch_global = allgather_host_data
