"""Host copies of device state: a parameter set or an optimizer's state
(counterpart of ``spatialthinker_tpu/parallel/offload.py``).

``offload_to_host`` turns every tensor leaf of a nested dict / list / tuple
(a ``state_dict``, an optimizer's ``{"count", "mu", ...}``) into a
``HostLeaf``: a host copy of its own (one per leaf, never one block for the
whole tree) and the device it came from. ``restore_from_host`` puts each leaf
back on that device in its dtype. Leaves that are not tensors (a step count)
pass through both unchanged.

A host copy of a CUDA tensor is page-locked, so both directions are DMA
copies. The memory is a plain anonymous mapping page-locked by
``cudaHostRegister`` for exactly its own size: the caching host allocator
behind ``pin_memory()`` rounds each block up to a power of two, which at 7B
(a 272 MB gate_up leaf held in a 512 MB block) would ask the host for nearly
twice what the copies hold. A copy of a CPU tensor (the tests) is a plain
CPU tensor.

The JAX module keeps one buffer per distinct shard of a global array and
rebuilds the array over its mesh. Here a process owns one GPU: on several
GPUs the trainer hands this module each rank's own shards
(``sharding.local``), so a leaf is one tensor on one device either way.
"""

from __future__ import annotations

import mmap
from typing import NamedTuple

import torch


class HostLeaf(NamedTuple):
    """One offloaded tensor: its host copy and the device it came from."""

    buffer: torch.Tensor
    device: torch.device


class _RegisteredMapping(mmap.mmap):
    """Anonymous memory that stays page-locked from its registration until
    the last tensor over it is gone (then it is unregistered before the
    mapping is unmapped)."""

    registered_ptr = 0
    unregister = None  # bound at registration: no module lookup at teardown

    def __del__(self):
        if self.registered_ptr:
            self.unregister(self.registered_ptr)
            self.registered_ptr = 0


def pinned_zeros(shape, dtype: torch.dtype) -> torch.Tensor:
    """A zero-filled CPU tensor (fresh anonymous memory) in page-locked
    memory of exactly its own size, rounded to whole pages. Needs a CUDA
    device."""
    shape = tuple(shape)
    n_bytes = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
    if n_bytes == 0:
        return torch.zeros(shape, dtype=dtype)
    mapping = _RegisteredMapping(-1, n_bytes)
    flat = torch.frombuffer(mapping, dtype=torch.uint8, count=n_bytes)  # keeps the mapping alive
    cudart = torch.cuda.cudart()
    err = cudart.cudaHostRegister(flat.data_ptr(), n_bytes, 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of {n_bytes} bytes failed with CUDA error {int(err)}")
    mapping.registered_ptr, mapping.unregister = flat.data_ptr(), cudart.cudaHostUnregister
    return flat.view(dtype).view(shape)


def host_copy(x: torch.Tensor, *, non_blocking: bool = False) -> torch.Tensor:
    """A host copy of ``x``: page-locked when ``x`` is on a CUDA device.
    With ``non_blocking`` the device-to-host copy is queued on the current
    stream, and the caller synchronizes before it reads the copy."""
    if not x.is_cuda:
        return x.detach().clone()
    out = pinned_zeros(x.shape, x.dtype)
    out.copy_(x.detach(), non_blocking=non_blocking)
    return out


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``, which share its structure)."""
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v, *(r[k] for r in rest))) for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, HostLeaf):
        return type(tree)(_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)) or isinstance(tree, HostLeaf):
        yield tree
        return
    for v in tree:
        yield from _leaves(v)


def offload_to_host(tree, into=None):
    """Device tree -> tree of ``HostLeaf``. ``into``, a tree this call
    returned before for the same leaves, is written over and returned instead
    of allocating new host copies. The copies complete before the call
    returns, so the caller may drop the device tree at once."""
    if into is None:
        out = _map(lambda x: HostLeaf(host_copy(x, non_blocking=True), x.device)
                   if isinstance(x, torch.Tensor) else x, tree)
    else:
        def write(x, h):
            if not isinstance(h, HostLeaf):
                return x
            h.buffer.copy_(x.detach(), non_blocking=True)
            return h

        out = _map(write, tree, into)
    _synchronize()
    return out


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


def restore_from_host(tree):
    """Inverse of ``offload_to_host``: every leaf back on its device, in its
    dtype, as a new tensor. The copies complete before the call returns, so
    the caller may drop the host tree at once."""
    out = _map(lambda h: h.buffer.to(h.device, non_blocking=True) if isinstance(h, HostLeaf) else h,
               tree)
    _synchronize()
    return out


def is_offloaded(tree) -> bool:
    return any(isinstance(x, HostLeaf) for x in _leaves(tree))


def host_bytes(tree) -> int:
    """Bytes the host copies of ``tree`` hold."""
    return sum(x.buffer.numel() * x.buffer.element_size() for x in _leaves(tree) if isinstance(x, HostLeaf))


def host_view(tree):
    """``tree`` with every ``HostLeaf`` as its host copy (the same tensor,
    not a copy)."""
    return _map(lambda x: x.buffer if isinstance(x, HostLeaf) else x, tree)
