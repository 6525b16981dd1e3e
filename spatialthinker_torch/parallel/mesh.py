"""The device mesh of a multi-GPU run (counterpart of
``spatialthinker_tpu/parallel/mesh.py``): one process per GPU, the ranks laid
out as a ``(data, fsdp, model)`` grid, rank ``(d * fsdp + f) * model + m``.

- ``data``  -- replica axis: parameters are replicated over it (HSDP's
  replicate dim), rows are split over it.
- ``fsdp``  -- parameter-shard axis (ZeRO-3); rows are split over it too.
- ``model`` -- the ranks of one ``model`` group hold the same rows. With
  sequence parallelism (sp = ``model_size``) they split their sequence
  (Ulysses or ring attention, ``ops/``) and parameters are sharded over the
  axis as over ``fsdp`` (a memory layout; JAX shards the MLP over ``model``
  there too, the same math). Without sp it is Megatron tensor parallelism
  (``tp_group``, ``parallel/tensor.py``): each rank holds its TP shard of
  every weight, built at local widths, and FSDP shards that over
  ``(data, fsdp)`` only (``fsdp_mesh``).

There is no ``NamedSharding`` or ``PartitionSpec``. What takes their place:
a parameter is a ``DTensor`` that ``fully_shard`` placed on ``shard_mesh``
(``(data, fsdp x model)``: Replicate, then Shard(0)) or, under TP, on
``fsdp_mesh`` (``(data, fsdp)``) of a TP-local module; a batch is each
rank's own rows as plain tensors, the ``batch_group`` ranks holding disjoint
rows (the JAX ``P(BATCH_AXES)``) and the ``model`` group's ranks the same
rows (split along the sequence under sp: the JAX ``P(BATCH_AXES, "model")``
of sequence-parallel activations).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS)

# rows are split over both data-like axes
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)


def create_mesh(data_size: int = 1, fsdp_size: int = -1, model_size: int = 1,
                device_type: str = "cuda") -> DeviceMesh:
    """The ``(data, fsdp, model)`` mesh over every rank of the default process
    group; ``fsdp_size`` -1 takes every rank the other two leave."""
    n = dist.get_world_size()
    if fsdp_size == -1:
        assert n % (data_size * model_size) == 0, (
            f"{n} devices not divisible by data={data_size} * model={model_size}"
        )
        fsdp_size = n // (data_size * model_size)
    assert data_size * fsdp_size * model_size == n, (
        f"mesh {data_size}x{fsdp_size}x{model_size} != {n} devices"
    )
    return init_device_mesh(device_type, (data_size, fsdp_size, model_size), mesh_dim_names=AXES)


def _ranks(mesh: DeviceMesh) -> torch.Tensor:
    return mesh.mesh.reshape(mesh.shape)


@functools.lru_cache(maxsize=None)
def shard_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """``(data, shard)``: the mesh ``fully_shard`` takes, parameters
    replicated over ``data`` and sharded over ``fsdp x model``."""
    d, f, m = mesh.shape
    return DeviceMesh(mesh.device_type, _ranks(mesh).reshape(d, f * m),
                      mesh_dim_names=(DATA_AXIS, "shard"))


@functools.lru_cache(maxsize=None)
def _batch_mesh(mesh: DeviceMesh) -> DeviceMesh:
    d, f, m = mesh.shape
    return DeviceMesh(mesh.device_type, _ranks(mesh).reshape(d * f, m),
                      mesh_dim_names=("batch", MODEL_AXIS))


def fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """``(data, fsdp)`` of this rank's ``model`` index, the mesh FSDP takes
    under tensor parallelism; ``fsdp`` alone with one replica."""
    return mesh[FSDP_AXIS] if mesh.shape[0] == 1 else mesh[(DATA_AXIS, FSDP_AXIS)]


def batch_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The ranks holding disjoint rows (``data x fsdp``, one ``model``
    index): row slicing, row negotiation and batch reductions."""
    return _batch_mesh(mesh).get_group("batch")


def batch_rank(mesh: DeviceMesh) -> int:
    return dist.get_rank(batch_group(mesh))


def sp_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The ranks of one ``model`` group: the same rows, the sequence split."""
    return mesh.get_group(MODEL_AXIS)


def tp_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The ranks of one ``model`` group under tensor parallelism: the same
    rows, each rank its shard of every weight."""
    return mesh.get_group(MODEL_AXIS)


def norm_group(mesh: DeviceMesh, tensor_parallel: bool = False) -> dist.ProcessGroup:
    """The ranks whose parameter shards together make one copy of the
    parameters (``fsdp x model``): a global norm sums over these. Under
    tensor parallelism one copy of this rank's TP shards (``fsdp``); the
    norm then adds the TP group's split leaves (``train_step``)."""
    if tensor_parallel:
        return mesh.get_group(FSDP_AXIS)
    return shard_mesh(mesh).get_group("shard")
